"""Deal all-node GNN inference launcher for the port (the paper's
pipeline, Fig 2): argparse -> ``DealConfig`` -> ``api.Session``.

  PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
      --dataset ogbn-products --model gcn --p 4 --m 2  # mesh, on the card
  PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
      --dataset ogbn-products --p 4 --m 2 --device cpu # mesh on the CPU
  PYTHONPATH=src python -m repro_torch.launch.infer_gnn --local  # 1 device

  # dump the effective config, then reproduce the run from it alone
  python -m repro_torch.launch.infer_gnn --model gat --dump-config run.json
  python -m repro_torch.launch.infer_gnn --config run.json --device cpu

Configs are those of the JAX launcher (``repro.launch.infer_gnn``), and
so is the default executor: "dist", the §3.4 primitives on a ``--p`` x
``--m`` mesh of shards in this one process (on one card all shards share
it).  ``--local`` runs one device instead: "cuda" (the hand-written
kernels) on a card, "ref" (plain PyTorch) on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.api import (ConfigError, DealConfig, ExecutorSpec,
                             GraphSpec, ModelSpec, PartitionSpec, Session)
from repro_torch.core.ops import local_executor_name


def _run_session(cfg: DealConfig, device: str):
    try:
        s = Session.build(cfg, device=device)
    except ConfigError as e:
        raise SystemExit(str(e))
    with s:
        cs = s.construct_stats
        print(f"[construct] {s.n_nodes} nodes, {s.graph.n_edges} edges in "
              f"{s.timings['construct_s']:.2f}s "
              f"(exchange {cs['exchanged_bytes']/1e6:.1f} MB)")
        print(f"[sample] {cfg.model.n_layers} layer graphs, "
              f"fanout {cfg.graph.fanout} in {s.timings['sample_s']:.2f}s")
        n_edges = s.graph.n_edges
        H = s.infer_all()
        t_inf = s.timings["infer_s"]
        mesh = getattr(s.executor, "mesh", None)
        print(f"[infer] embeddings {tuple(H.shape)} for ALL nodes in "
              f"{t_inf:.2f}s ({n_edges/max(t_inf, 1e-9)/1e6:.2f} M edges/s, "
              f"executor={s.executor.name}, device={s.device})"
              + (f" on {mesh}" if mesh is not None else ""))
        return H


def run(dataset: str, model: str = "gcn", p: int = 2, m: int = 1,
        fanout: int = 8, n_layers: int = 3, d_feature: int = 64,
        seed: int = 0, distributed: bool = True, executor: str = "dist",
        scale: float = 1.0, device: str = "cuda"):
    """DEPRECATED shim — the pre-API entry point, kept for callers (the
    twin of ``repro.launch.infer_gnn.run``).  Builds the equivalent
    ``DealConfig`` and delegates to ``Session`` on ``device`` ("cuda" by
    default, which raises without a card).  ``executor`` selects the
    backend: "dist" (the mesh), "ref" (plain PyTorch) or "cuda" (the
    kernels); ``distributed=False`` turns "dist" into "ref", as in JAX:
    the caller's choice of executor, not a fallback."""
    if executor == "dist" and not distributed:
        executor = "ref"                # no mesh asked for: plain PyTorch
    cfg = DealConfig(
        graph=GraphSpec(dataset=dataset, scale=scale, fanout=fanout,
                        seed=seed, n_construct_workers=p),
        model=ModelSpec(name=model, n_layers=n_layers,
                        d_feature=d_feature),
        partition=PartitionSpec(p=p, m=m),
        executor=ExecutorSpec(name=executor))
    return _run_session(cfg, device)


def config_from_args(args) -> DealConfig:
    executor = (local_executor_name(args.device)
                if args.executor == "dist" and args.local else args.executor)
    return DealConfig(
        graph=GraphSpec(dataset=args.dataset, scale=args.scale,
                        fanout=args.fanout, seed=args.seed,
                        n_construct_workers=args.p),
        model=ModelSpec(name=args.model, n_layers=args.layers,
                        d_feature=args.d_feature),
        partition=PartitionSpec(p=args.p, m=args.m),
        executor=ExecutorSpec(name=executor))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="CFG.json",
                    help="load the full DealConfig from a JSON artifact "
                         "(overrides every pipeline flag)")
    ap.add_argument("--dump-config", default=None, metavar="OUT.json",
                    help="write the effective DealConfig ('-' = stdout) "
                         "and exit without running")
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--model", default="gcn")
    ap.add_argument("--p", type=int, default=2,
                    help="graph partitions (CSR construction width)")
    ap.add_argument("--m", type=int, default=1, help="feature partitions")
    ap.add_argument("--fanout", type=int, default=8)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--d-feature", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale the dataset's node count")
    ap.add_argument("--local", action="store_true",
                    help="one device instead of the mesh: the cuda "
                         "executor on a card, ref on the CPU")
    ap.add_argument("--executor", default="dist",
                    help="backend: dist mesh / cuda kernels / ref plain "
                         "PyTorch (or any registered executor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        cfg = (DealConfig.load(args.config) if args.config
               else config_from_args(args))
        cfg.validate()
    except ConfigError as e:
        raise SystemExit(str(e))
    if args.dump_config:
        if args.dump_config == "-":
            print(cfg.to_json())
        else:
            cfg.dump(args.dump_config)
            print(f"[config] wrote {args.dump_config}")
        return None
    return _run_session(cfg, args.device)


if __name__ == "__main__":
    main()
