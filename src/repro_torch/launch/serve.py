"""Serving launcher: batched requests through the ``ServeEngine`` (the
twin of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --requests 6 --max-new 16                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch deepseek-v2-236b              # the moe family: MLA + experts
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-1.3b                   # ssm: Mamba-2 (or zamba2-7b)

Every family the engine drives serves: dense, moe, ssm and hybrid (the
engine refuses audio and vlm, as the JAX one does).

Without ``cfg=`` the architecture runs ``reduced()``, as in JAX; pass
``cfg=get_config(arch)`` for the full width.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeEngine


def run(arch: str, *, n_requests: int = 6, max_new: int = 16,
        batch_slots: int = 4, max_seq: int = 128, seed: int = 0,
        params=None, cfg=None,
        device="cuda") -> Tuple[List[Request], Dict[str, float]]:
    """Serve ``n_requests`` random prompts of 3 to 11 tokens.  Returns the
    requests and {"tokens", "decode_steps", "seconds"} (the engine's run,
    ended by its last step's copy of the logits to the host)."""
    cfg = cfg or get_config(arch).reduced()
    params = (params if params is not None
              else transformer.init_params(cfg, seed, device=device))
    eng = ServeEngine(cfg, params, batch_slots=batch_slots, max_seq=max_seq,
                      device=device)
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        plen = int(rng.integers(3, 12))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        r = Request(uid=uid, prompt=prompt, max_new_tokens=max_new)
        reqs.append(r)
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"served {n_requests} requests, {total_new} tokens, "
          f"{eng.n_decode_steps} decode steps, {dt:.1f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s) on {eng.device}")
    for r in reqs:
        if not (r.done and r.out_tokens):
            raise RuntimeError(f"request {r.uid} did not finish")
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens[:8]}{'...' if len(r.out_tokens) > 8 else ''}")
    return reqs, {"tokens": total_new, "decode_steps": eng.n_decode_steps,
                  "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, n_requests=args.requests, max_new=args.max_new,
        batch_slots=args.slots, device=args.device)


if __name__ == "__main__":
    main()
