"""The three-term roofline of a dry-run record — the twin of
``repro.roofline.analysis``, with the H100's table in place of the
TPU's:

  compute    = FLOPs / (chips * peak FLOP/s)
  memory     = bytes / (chips * HBM bytes/s)
  collective = collective bytes a chip / link bytes/s

The FLOPs and bytes come from the dry-run's trace
(``launch.dryrun``).  JAX parses its collective bytes out of XLA's HLO
text (``collective_bytes_from_hlo``); the port has no HLO, so it counts
the messages of its own placed step instead: on the production meshes
the dry-run runs that step on a meta mesh and gives the bytes the
busiest receiving shard receives, by JAX's kinds (its ``collectives``
record); on the card mesh the term is 0 (one device, no collective).
A None payload (not known) leaves the term None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SOURCE = "NVIDIA H100 SXM5 80GB HBM3, 700 W, data sheet"

# one NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, from the data sheet
# (dense rates, no sparsity); every entry is that source's
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, bf16 dense on the tensor cores
    "peak_flops_f32": 67e12,     # FLOP/s, f32 outside the tensor cores
    "hbm_bw": 3.35e12,           # B/s, HBM3
    "link_bw": 450e9,            # B/s each way, NVLink
    "hbm_bytes": 80e9,           # B of HBM3
}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: Optional[float]

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max((k for k, v in vals.items() if v is not None),
                   key=vals.get)

    def as_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        return d


def roofline_terms(*, total_flops: float, total_bytes: float,
                   collective_bytes_per_chip: Optional[float], n_chips: int,
                   flops_are_global: bool = True) -> RooflineTerms:
    """JAX's formula with the H100's rates.  ``flops_are_global``: the
    totals are the whole step's and are divided over the chips (the
    port's trace is global); a None collective payload (not known)
    leaves its term None."""
    f = total_flops / n_chips if flops_are_global else total_flops
    b = total_bytes / n_chips if flops_are_global else total_bytes
    c = collective_bytes_per_chip
    return RooflineTerms(
        compute_s=f / HW["peak_flops_bf16"],
        memory_s=b / HW["hbm_bw"],
        collective_s=None if c is None else c / HW["link_bw"],
        flops_per_chip=f,
        bytes_per_chip=b,
        collective_bytes_per_chip=c,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N the active
    params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens
