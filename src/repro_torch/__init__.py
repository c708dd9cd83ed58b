"""repro_torch — Deal's all-node GNN inference in PyTorch, for one H100.

The counterpart of the JAX package ``repro``, module for module: the
same names under ``api/``, ``core/``, ``kernels/`` and ``launch/``.  It
imports ``torch`` and numpy and nothing of ``repro`` or ``jax``; the
numpy modules it needs (graph build, sampling, config) are its own
copies.  The Pallas kernels of ``repro.kernels`` are CUDA C++ kernels
here (``kernels/csrc``), built with ``nvcc`` at first use.

    from repro_torch.api import DealConfig, Session
    with Session.build(DealConfig.load("cfg.json")) as s:   # on "cuda"
        H = s.infer_all()
"""
