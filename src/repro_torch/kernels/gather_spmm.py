"""``gather_spmm``: SPMM with the id translation fused into the gather
(Deal §3.5, Fig 13).

    out[i] = sum_f w[i,f] * mask[i,f] * h[table[nbr[i,f]]]

Replaces the Pallas TPU kernel
``src/repro/kernels/gather_spmm.py::gather_spmm`` (``pallas_call`` at
line 72) with the kernel of ``csrc/spmm.cu`` given the table pointer:
one extra int32 load per edge instead of materializing ``h[table]``.
Same per-row order of sums as ``spmm``, so it equals ``spmm`` over the
materialized reorder bitwise.  On a CPU tensor the wrapper returns the
plain version, ``ref.gather_spmm_ref`` (``ref.gather_spmm_heads_ref``
for (R, F, heads) weights).  ``gather_spmm.launches`` counts kernel
launches.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.spmm import check_shapes, launch_spmm

SOURCE = "src/repro_torch/kernels/csrc/spmm.cu"
REPLACES = "src/repro/kernels/gather_spmm.py:72"


def gather_spmm(h, table, w, nbr, mask, *, block_rows=None,
                block_cols=None):
    """out[i] = sum_f w[i,f]*mask[i,f]*h[table[nbr[i,f]]].

    h: (U, D) f32/bf16 rows in any order; table: (N,) int32 map from
    the ids in ``nbr`` onto h's rows; mask, nbr: (R, F); w: (R, F) or
    (R, F, heads), as ``spmm`` takes it.  Every id and table entry must
    be in range, masked slots included (their coefficient is 0.0).
    Returns (R, D) in h's dtype."""
    check_shapes(h, nbr, mask, w)
    if table.dim() != 1:
        raise ValueError(f"table must be 1-D, got {tuple(table.shape)}")
    if h.device.type == "cpu":
        return ref.gather_spmm_heads_ref(h, table, w, nbr, mask)
    if h.device.type != "cuda":
        raise ValueError(f"gather_spmm: no kernel for device {h.device}")
    out, launched = launch_spmm("gather_spmm", h, table, w, nbr, mask,
                                block_rows, block_cols)
    gather_spmm.launches += launched
    return out


gather_spmm.launches = 0
