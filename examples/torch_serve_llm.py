"""Serve a small model with batched requests on the PyTorch port: a
batched prefill through the flash-attention kernel, then
continuous-batching decode through the ``ServeEngine`` (the twin of
``examples/serve_llm.py``).

  PYTHONPATH=src python examples/torch_serve_llm.py [--arch qwen2.5-14b]
  PYTHONPATH=src python examples/torch_serve_llm.py --device cpu
  PYTHONPATH=src python examples/torch_serve_llm.py --device cpu \
      --arch mamba2-1.3b                   # or zamba2-7b (Mamba-2 hybrid)

The architecture runs ``reduced()``, as in the JAX example.  On the CPU
the prefill's attention runs the kernel wrapper's plain version.  mamba2
has no attention, so its prefill launches no kernel; zamba2's launches
one a super-block.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer
    from repro_torch.serve.step import prefill_step

    cfg = get_config(args.arch).reduced()
    params = transformer.init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)

    # --- batched prefill: last-position logits and the filled cache ---
    B, S = 4, 32
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device=params.embed.device)
    ops.reset_launch_counts()
    t0 = time.time()
    logits, cache = prefill_step(cfg, params, {"tokens": tokens})
    if logits.is_cuda:
        torch.cuda.synchronize()
    print(f"batched prefill: {B}x{S} tokens -> last-pos logits "
          f"{tuple(logits.shape)} in {time.time() - t0:.2f}s (cache "
          f"filled; {ops.launch_counts()['flash_attention']} flash "
          "kernel launches)")

    # --- continuous-batching decode over ragged requests ---
    run(args.arch, n_requests=args.requests, max_new=args.max_new,
        batch_slots=args.slots, max_seq=64, params=params, cfg=cfg,
        device=args.device)


if __name__ == "__main__":
    main()
