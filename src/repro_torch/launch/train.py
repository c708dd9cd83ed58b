"""Training launcher — the twin of ``repro.launch.train``: init params,
AdamW state, the data pipeline, and ``train_step`` over it, logging as
the JAX launcher logs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 50 --batch 8 --seq 128                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5

Without ``cfg=`` the architecture runs ``reduced()`` unless
``reduced=False`` (``--full``), as in JAX; pass ``cfg=`` for a config of
one's own (``examples/torch_train_lm.py``).  The vlm and audio families
are refused, as JAX refuses them.

``mesh=`` (a ``launch.mesh.Mesh``, e.g. ``make_host_mesh(4, 1)``: its
shards round-robin over the visible cards, or ``device="cpu"``) places
the params and the AdamW state by ``sharding.param_specs`` and each batch
by ``batch_specs`` (``jax.device_put`` with ``NamedSharding``s, as the
JAX launcher does) and runs the steps inside ``sharding_context(mesh)``:
each step is data parallel over the mesh's ``data`` shards
(``train.step._placed_train_step``).  ``device=`` must be the mesh's
home.  ``--production-mesh`` (16 x 16: 256 devices) raises
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.ops import resolve_device
from repro_torch.launch.mesh import check_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.sharding.context import sharding_context
from repro_torch.sharding.placement import place_module, place_tree
from repro_torch.sharding.specs import batch_specs, param_specs
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import DataConfig, make_pipeline
from repro_torch.train.optimizer import AdamWConfig, OptState, init_opt_state
from repro_torch.train.step import train_step


def run(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
        reduced: bool = True, lr: float = 3e-4, log_every: int = 10,
        checkpoint_path=None, mesh=None, seed: int = 0, cfg=None,
        device="cuda", attn_backend: str = "cuda"):
    """Train ``steps`` steps on the synthetic stream from ``seed``.
    Returns (params, the per-step CE losses).  ``device`` "cuda" (the
    default) raises without a card; ``attn_backend`` is the attention's
    route ("cuda": the flash kernel in the forward); ``mesh``: a mesh
    whose home is ``device``."""
    dev = resolve_device(device)
    if mesh is not None:
        check_mesh(mesh, dev)
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("use the family-specific example scripts")
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    params = transformer.init_params(cfg, seed, device=dev)
    params.requires_grad_(True)
    opt_state = init_opt_state(params, opt_cfg)
    if mesh is not None:
        specs = param_specs(cfg, params, mesh)
        params = place_module(params, specs, mesh)
        opt_state = place_tree(opt_state, OptState((), specs, specs), mesh)
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    batch_size=batch, seed=seed))
    losses = []
    t0 = time.time()
    with (sharding_context(mesh) if mesh is not None
          else contextlib.nullcontext()):
        for i in range(steps):
            host = next(data)
            batch_dev = {k: torch.as_tensor(v, device=dev)
                         for k, v in host.items()}
            if mesh is not None:
                batch_dev = place_tree(batch_dev, batch_specs(
                    cfg, batch_dev, mesh, None), mesh, kind="batch")
            params, opt_state, metrics = train_step(
                cfg, opt_cfg, params, opt_state, batch_dev,
                attn_backend=attn_backend)
            losses.append(float(metrics["loss"]))
            if (i + 1) % log_every == 0 or i == 0:
                print(f"step {i+1:5d}  loss {losses[-1]:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"{(time.time()-t0)/(i+1):.2f}s/step", flush=True)
    data.close()
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, opt_state, step=steps,
                        cfg=cfg)
        print("saved", checkpoint_path)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 devices): raises")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        check_mesh(make_production_mesh(), args.device)
    run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, lr=args.lr, checkpoint_path=args.checkpoint,
        device=args.device)


if __name__ == "__main__":
    main()
