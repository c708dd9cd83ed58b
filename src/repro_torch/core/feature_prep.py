"""Feature preparation fused with the first primitive (§3.5, Fig 13) —
the port's twin of ``write_feature_files`` and ``fused_load_spmm`` in
``repro.core.feature_prep``.

Feature files on disk are not sorted by node id.  The fused strategy
loads them in file order, records a location table (node id -> loader
position), runs layer 1's GEMM over the rows in loader order, and lets
the first aggregation consume the table directly: on the cuda executor
that is the ``gather_spmm`` kernel, so no reordered copy of the
features is ever made.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from repro_torch import obs


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
    loaded_ids, loaded_rows = [], []
    file_rows = 0
    for m in range(n_machines):
        for f in files[m::n_machines]:
            z = np.load(f)
            loaded_ids.append(z["ids"]); loaded_rows.append(z["rows"])
            file_rows += z["ids"].size
    ids = np.concatenate(loaded_ids)
    rows = np.concatenate(loaded_rows)
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
    obs.add("featprep.fused_spmm.file_rows", stats["file_rows"])
    obs.add("featprep.fused_spmm.net_rows", stats["net_rows"])
    return agg, stats
