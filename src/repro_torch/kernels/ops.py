"""The kernel layer the executors import — the port's twin of
``repro.kernels.ops``.

Dispatch is on the tensors' device, inside each wrapper: a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
version in ``kernels.ref``.  There is no backend probe and no fallback.
(GEMM has no kernel: the executors call ``ref.gemm_ref``, that is
``torch.matmul``, as the JAX package leaves GEMM to XLA.)

``KERNELS`` lists the six kernels with their plain versions, sources
and the TPU kernels they replace (``rgat_attention``, R-GAT's attention,
replaces none: the JAX package has no relational GNN);
``launch_counts`` and ``reset_launch_counts`` read and zero their launch
counters (the reset also zeroes the counts of a kernel's second path:
``flash_attention.launches_tc``, the bf16 tensor-core kernel's share of
``flash_attention``'s, and ``gat_attention.launches_wide`` /
``sddmm.launches_wide``, the wide scoring kernel's; and
``mean_weights.launches``, whose kernel replaces no TPU kernel but the
host's numpy mean weights, so ``KERNELS`` does not list it).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gat_attention as _gat
from repro_torch.kernels import gather_spmm as _gather
from repro_torch.kernels import mean_weights as _mean_weights
from repro_torch.kernels import ref
from repro_torch.kernels import sddmm as _sddmm
from repro_torch.kernels import spmm as _spmm

spmm = _spmm.spmm
gather_spmm = _gather.gather_spmm
gat_attention = _gat.gat_attention
rgat_attention = _gat.rgat_attention
sddmm = _sddmm.sddmm
flash_attention = _flash.flash_attention
mean_weights = _mean_weights.mean_weights

# R-GAT's attention: gat_attention.cu's source, no TPU kernel replaced
_RGAT = SimpleNamespace(SOURCE=_gat.SOURCE, REPLACES=None)

# name -> (wrapper, plain version, module with SOURCE / REPLACES)
KERNELS = {
    "spmm": (spmm, ref.spmm_ref, _spmm),
    "gather_spmm": (gather_spmm, ref.gather_spmm_ref, _gather),
    "gat_attention": (gat_attention, ref.gat_attention_ref, _gat),
    "sddmm": (sddmm, ref.sddmm_ref, _sddmm),
    "flash_attention": (flash_attention, ref.flash_attention_ref, _flash),
    "rgat_attention": (rgat_attention, ref.rgat_attention_ref, _RGAT),
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    flash_attention.launches_tc = 0
    flash_attention.launches_by_device.clear()
    gat_attention.launches_wide = 0
    sddmm.launches_wide = 0
    mean_weights.launches = 0
