"""End-to-end driver for the PyTorch port — the paper's workload (Fig 2):
compute embeddings for ALL nodes of a graph, distributed over a (P x M)
mesh.

Runs the full pipeline: edge list -> DEAL CSR construction -> layer-wise
1-hop sampling -> 1-D + feature collaborative partition -> distributed
layer-by-layer inference with the §3.4 primitives, via
``repro_torch.launch.infer_gnn``.  The mesh's P x M shards live in this
one process (on one card they all share it; every message between them
is still a copy), so unlike the JAX example nothing is respawned.

  PYTHONPATH=src python examples/torch_allnode_inference.py      # 4x2 mesh
  PYTHONPATH=src python examples/torch_allnode_inference.py --local
  PYTHONPATH=src python examples/torch_allnode_inference.py \
      --device cpu --scale 0.125

``--local`` runs one device: the "cuda" executor (the hand-written
kernels) on a card, the plain versions on the CPU.
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

    from repro_torch.launch.infer_gnn import main as infer_main
    p, m = (1, 1) if args.local else (args.p, args.m)
    return infer_main(["--dataset", args.dataset, "--model", args.model,
                       "--p", str(p), "--m", str(m), "--scale",
                       str(args.scale), "--device", args.device]
                      + (["--local"] if args.local else []))


if __name__ == "__main__":
    main()
