"""Feature preparation (§3.5 Fig 13, evaluated in Fig 21) — the port's
twin of ``repro.core.feature_prep``.

Feature files on disk are NOT sorted by node id.  Strategies to get a
partitioned feature tensor ready for layer 1:

  scan_all      every machine scans ALL files and keeps its rows
                (O(M*N) file traffic — the Fig 21 baseline);
  redistribute  each machine loads 1/M of the files then shuffles rows
                to owners (O(N/M) file + O((M-1)N/M) network);
  fused         each machine loads 1/M, records a location table, and
                the first GEMM consumes loader-ordered rows directly —
                the shuffle disappears into layer 1's gather;
  fused_spmm    the fused strategy through an executor: layer 1's GEMM
                over the rows in loader order, and the first aggregation
                consuming the table directly.  On the cuda executor that
                is the ``gather_spmm`` kernel, so no reordered copy of
                the features is ever made.

The first three are host-side loader baselines in numpy, as in the JAX
package: "machines" are loop iterations and the network is a memcpy,
but the byte counts are exact.  ``fused_load_spmm`` is the path that
runs on the card.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from repro_torch import obs


def _count_rows(strategy: str, stats: Dict) -> None:
    """One counter pair per loader run (file vs network rows), under
    the JAX package's names — the Fig 21 stage breakdown."""
    obs.add(f"featprep.{strategy}.file_rows", stats["file_rows"])
    obs.add(f"featprep.{strategy}.net_rows", stats["net_rows"])


def write_feature_files(path, N: int, D: int, n_files: int = 8,
                        seed: int = 0) -> Tuple[list, np.ndarray]:
    """Unsorted feature files: (ids, rows) pairs.  Same seed, same
    files and features as ``repro.core.feature_prep``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    feats = rng.standard_normal((N, D), dtype=np.float32)
    files = []
    bounds = np.linspace(0, N, n_files + 1).astype(int)
    for i in range(n_files):
        ids = perm[bounds[i]:bounds[i + 1]]
        f = f"{path}/feat_{i}.npz"
        np.savez(f, ids=ids, rows=feats[ids])
        files.append(f)
    return files, feats


def scan_all_load(files, n_machines: int, N: int, D: int):
    """Every machine reads every file; file traffic = M * N rows."""
    with obs.span("featprep.scan_all",
                  {"n_machines": n_machines} if obs.enabled() else None):
        return _scan_all_load(files, n_machines, N, D)


def _scan_all_load(files, n_machines: int, N: int, D: int):
    t0 = time.perf_counter()
    bounds = np.linspace(0, N, n_machines + 1).astype(int)
    out = np.zeros((N, D), np.float32)
    file_rows = 0
    for m in range(n_machines):
        lo, hi = bounds[m], bounds[m + 1]
        for f in files:
            z = np.load(f)
            ids, rows = z["ids"], z["rows"]
            file_rows += ids.size
            sel = (ids >= lo) & (ids < hi)
            out[ids[sel]] = rows[sel]
    stats = {"seconds": time.perf_counter() - t0,
             "file_rows": file_rows, "net_rows": 0}
    _count_rows("scan_all", stats)
    return out, stats


def redistribute_load(files, n_machines: int, N: int, D: int):
    """Each machine loads 1/M of the files, then shuffles to owners."""
    with obs.span("featprep.redistribute",
                  {"n_machines": n_machines} if obs.enabled() else None):
        return _redistribute_load(files, n_machines, N, D)


def _redistribute_load(files, n_machines: int, N: int, D: int):
    t0 = time.perf_counter()
    bounds = np.linspace(0, N, n_machines + 1).astype(int)
    loaded = []          # per machine: (ids, rows)
    file_rows = 0
    for m in range(n_machines):
        ids_l, rows_l = [], []
        for f in files[m::n_machines]:
            z = np.load(f)
            ids_l.append(z["ids"]); rows_l.append(z["rows"])
            file_rows += z["ids"].size
        loaded.append((np.concatenate(ids_l) if ids_l else np.empty(0, int),
                       np.concatenate(rows_l) if rows_l
                       else np.empty((0, D), np.float32)))
    # shuffle pass (network)
    out = np.zeros((N, D), np.float32)
    net_rows = 0
    for m in range(n_machines):
        ids, rows = loaded[m]
        owner = np.searchsorted(bounds, ids, side="right") - 1
        net_rows += int((owner != m).sum())
        out[ids] = rows
    stats = {"seconds": time.perf_counter() - t0,
             "file_rows": file_rows, "net_rows": net_rows}
    _count_rows("redistribute", stats)
    return out, stats


def _load_in_loader_order(files, n_machines: int):
    """Every file once, machine by machine: (ids, rows, file rows)."""
    loaded_ids, loaded_rows = [], []
    file_rows = 0
    for m in range(n_machines):
        for f in files[m::n_machines]:
            z = np.load(f)
            loaded_ids.append(z["ids"]); loaded_rows.append(z["rows"])
            file_rows += z["ids"].size
    return np.concatenate(loaded_ids), np.concatenate(loaded_rows), \
        file_rows


def fused_load(files, n_machines: int, N: int, D: int, w: np.ndarray):
    """Fused: no shuffle pass; the layer-1 GEMM gathers loader-ordered
    rows through the location table and emits output already in node
    order.  Returns H1 = X @ w computed without materializing the
    ordered X, plus stats with the location table."""
    with obs.span("featprep.fused",
                  {"n_machines": n_machines} if obs.enabled() else None):
        return _fused_load(files, n_machines, N, D, w)


def _fused_load(files, n_machines: int, N: int, D: int, w: np.ndarray):
    t0 = time.perf_counter()
    ids, rows, file_rows = _load_in_loader_order(files, n_machines)
    table = np.empty(N, np.int64)        # node id -> loader position
    table[ids] = np.arange(ids.size)
    h1 = rows[table] @ w                 # gather fused into the first GEMM
    stats = {"seconds": time.perf_counter() - t0,
             "file_rows": file_rows, "net_rows": 0, "table": table}
    _count_rows("fused", stats)
    return h1, stats


def fused_load_spmm(files, n_machines: int, N: int, D: int, w, lg,
                    executor):
    """Loader-order GEMM + table-indirect layer-1 aggregation.

    The GEMM runs over rows in loader order (per-row dots do not care
    about row order) and the aggregation consumes the location table
    through ``DenseIO.table``.  Returns the aggregated layer-1 output in
    node order (pre-activation, on the executor's device) plus stats.
    ``lg`` is layer 1's layer graph; ``executor`` one from ``core.ops``."""
    with obs.span("featprep.fused_spmm",
                  {"n_machines": n_machines} if obs.enabled() else None):
        return _fused_load_spmm(files, n_machines, N, D, w, lg, executor)


def _fused_load_spmm(files, n_machines: int, N: int, D: int, w, lg,
                     executor):
    from repro_torch.core.ops import DenseIO   # lazy: avoid an import cycle

    t0 = time.perf_counter()
    ids, rows, file_rows = _load_in_loader_order(files, n_machines)
    # the files must hold every node exactly once: a missing or foreign
    # id would leave a table entry unset, and the kernel reads it as is
    if ids.size != N or (N and (ids.min() < 0 or ids.max() >= N
                                or np.bincount(ids, minlength=N).max() > 1)):
        raise ValueError(f"feature files must hold each of the {N} node "
                         f"ids once; they hold {ids.size} ids")
    table = np.empty(N, np.int64)        # node id -> loader position
    table[ids] = np.arange(ids.size)
    h1_rows = executor.gemm(executor.prepare(rows), w)   # loader order!
    io = DenseIO(lg.nbr, lg.mask, table=table, device=executor.device)
    agg = executor.spmm(h1_rows, io.mean_w, io)
    stats = {"seconds": time.perf_counter() - t0,
             "file_rows": file_rows, "net_rows": 0, "table": table}
    _count_rows("fused_spmm", stats)
    return agg, stats
