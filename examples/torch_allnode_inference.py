"""End-to-end driver for the PyTorch port — the paper's workload (Fig 2):
compute embeddings for ALL nodes of a graph.

Runs the pipeline on one device: edge list -> DEAL CSR construction ->
layer-wise 1-hop sampling -> layer-by-layer inference through the
"cuda" executor (the hand-written kernels), via
``repro_torch.launch.infer_gnn``.

  PYTHONPATH=src python examples/torch_allnode_inference.py --local
  PYTHONPATH=src python examples/torch_allnode_inference.py --local \
      --device cpu --scale 0.125

Without ``--local`` the JAX example runs a (P x M) device mesh; the
port's distributed executor is not ported yet (ROADMAP Queue 1 item 5),
so that mode raises ``NotImplementedError``.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale the dataset's node count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    if not args.local:
        raise NotImplementedError(
            f"a {args.p} x {args.m} mesh needs the distributed executor, "
            "which is not ported yet (ROADMAP Queue 1 item 5); run with "
            "--local")
    from repro_torch.launch.infer_gnn import main as infer_main
    return infer_main(["--dataset", args.dataset, "--model", args.model,
                       "--p", "1", "--m", "1", "--scale", str(args.scale),
                       "--device", args.device])


if __name__ == "__main__":
    main()
