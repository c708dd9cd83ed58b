"""Quickstart for the PyTorch port: DEAL's layer-wise all-node GNN
inference, then one CUDA kernel held against its plain version.

  PYTHONPATH=src python examples/torch_quickstart.py               # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card the layer-wise engine runs the hand-written kernels ("cuda"
executor); on the CPU every kernel wrapper runs its plain PyTorch
version, and the last line says so.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.gnn_models import (init_gcn, mean_weights,  # noqa: E402
                                         params_to)
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.layerwise import local_gcn_infer  # noqa: E402
from repro_torch.core.ops import resolve_device  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--nodes", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.nodes

    # 1. a graph (edge list -> CSR, the paper's stage 1)
    src, dst = rmat_edges(n_nodes=n, n_edges=16 * n, seed=0)
    g = csr_from_edges(src, dst, n)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges")

    # 2. layer-wise 1-hop sampling: k independent layer graphs for ALL
    #    nodes (no multi-hop ego networks, 100% sharing)
    lgs = sample_layer_graphs(g, fanout=8, n_layers=3, seed=0)
    print(f"sampled {len(lgs)} layer graphs, fanout {lgs[0].fanout}")

    # 3. a 3-layer GCN, inferred for every node in one layer-by-layer pass
    X = np.random.default_rng(0).standard_normal((n, 64), dtype=np.float32)
    params = params_to(init_gcn(torch.Generator().manual_seed(0),
                                [64, 64, 64, 32]), dev)
    ops.reset_launch_counts()
    H = local_gcn_infer(lgs, X, params, device=dev)
    print(f"embeddings for all nodes: {tuple(H.shape)} on {H.device}, "
          f"finite={bool(torch.isfinite(H).all())}, spmm launches "
          f"{ops.launch_counts()['spmm']}")

    # 4. the spmm kernel against its plain version
    h = torch.as_tensor(X, device=dev)
    w = torch.as_tensor(mean_weights(lgs[0].mask), device=dev)
    nbr = torch.as_tensor(lgs[0].nbr, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(lgs[0].mask, device=dev)
    ops.reset_launch_counts()
    out = ops.spmm(h, w, nbr, mask)
    err = float((out - ref.spmm_ref(h, w, nbr, mask)).abs().max())
    if ops.launch_counts()["spmm"]:
        print(f"spmm kernel on {torch.cuda.get_device_name(dev)}: max err "
              f"vs its plain version {err:.3e}")
    else:
        print(f"spmm on {dev}: only the plain version ran (no kernel "
              f"launches on the CPU); max err {err:.3e}")


if __name__ == "__main__":
    main()
