"""``sddmm``: sampled dense-dense products over the fanout (GAT scoring
on the unfused path).

    e[i,f] = <q[i], k[nbr[i,f]]> * mask[i,f]

Replaces the Pallas TPU kernel ``src/repro/kernels/sddmm.py::sddmm``
(``pallas_call`` at line 48) with the scoring half of the kernels in
``csrc/gat_attention.cu`` (narrow or wide, as ``gat_attention.
kernel_for`` picks), which gather only live slots.  On a CPU tensor the
wrapper returns the plain version, ``ref.sddmm_ref``.  ``sddmm.launches``
counts kernel launches, ``sddmm.launches_wide`` those on the wide
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gat_attention import check_qk, launch_rows

SOURCE = "src/repro_torch/kernels/csrc/gat_attention.cu"
REPLACES = "src/repro/kernels/sddmm.py:48"


def sddmm(q, k, nbr, mask):
    """q: (N, D); k: (U, D) source rows, same dtype (f32 or bf16), each
    contiguous or a row-strided view with unit-stride columns (a column
    slice of a wider tensor: read in place, bitwise as its contiguous
    copy); nbr (int32, ids in [0, U)) and mask (bool): (N, F).  Returns
    (N, F) f32 scores, 0 at a masked slot."""
    check_qk(q, k, nbr, mask)
    if q.device.type == "cpu":
        return ref.sddmm_ref(q, k, nbr, mask)
    if q.device.type != "cuda":
        raise ValueError(f"sddmm: no kernel for device {q.device}")
    out = torch.empty(nbr.shape, dtype=torch.float32, device=q.device)
    kind = launch_rows("sddmm", q, k, nbr, mask, out, 1, softmax=False)
    sddmm.launches += kind is not None
    sddmm.launches_wide += kind == "wide"
    return out


sddmm.launches = 0
sddmm.launches_wide = 0
