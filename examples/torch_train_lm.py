"""Train a ~100M-parameter decoder LM on the PyTorch port with the full
stack: the data pipeline, the train step (flash kernel forward, the
plain version's backward, chunked CE), AdamW and a checkpoint in the
JAX package's layout (the twin of ``examples/train_lm.py``).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

``--tiny`` is the 2-layer d256 smoke variant (``reduced()``).  The
checkpoint restores in either package
(``repro.train.checkpoint.restore_checkpoint``).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402


def lm_100m() -> ModelConfig:
    """~100M params: 12L d768 12H(kv4) ff2048, 8k vocab (llama-style)."""
    return ModelConfig(
        arch_id="lm-100m", family="dense", source="examples/train_lm",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=8192, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer d256 smoke variant")
    ap.add_argument("--checkpoint", default="build/lm100m_torch.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import run

    cfg = lm_100m()
    if args.tiny:
        cfg = cfg.reduced()
    print(f"model: {cfg.arch_id} ({cfg.param_count()/1e6:.0f}M params, "
          f"tiny={args.tiny})")
    _, losses = run(cfg.arch_id, cfg=cfg, steps=args.steps,
                    batch=args.batch, seq=args.seq, lr=3e-4, log_every=5,
                    checkpoint_path=args.checkpoint or None,
                    device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
