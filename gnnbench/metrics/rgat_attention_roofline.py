"""``rgat_attention_roofline``: R-GAT's attention kernel's launches in the
traced epochs (``rgat_attention_kernel`` of ``csrc/gat_attention.cu``),
their least time by the yardstick over their device time, in %.  The
i-th launch is layer i mod L's, over that layer graph's slots.

What a launch needs (``attention_bytes``, ``attention_ops``): every mask
byte; the relation (int8) and table row (int32) of each live slot; one
source score a head for each distinct source node (a node that two
relations project counts once, so the bytes are at most what the kernel
reads); each row with a live slot's target scores of one relation; and
the (R, F, heads) f32 alpha written.  Operations: a live slot's score,
LeakyReLU, difference from the max, exp, sum and divide, a head each."""
import re

from gnnbench import yardstick

KERNEL = re.compile(r"\brgat_attention_kernel\b")
OPS_PER_SLOT_HEAD = 6


def attention_bytes(st, heads: int) -> int:
    return (st["R"] * st["F"] + st["nnz"] * (1 + 4)
            + st["uniq"] * heads * 4 + st["live_rows"] * heads * 4
            + st["R"] * st["F"] * heads * 4)


def attention_ops(st, heads: int) -> int:
    return OPS_PER_SLOT_HEAD * st["nnz"] * heads


def read(ctx):
    durs = [d for name, d in ctx.trace.get("kernels", ())
            if KERNEL.search(name)]
    if not durs or not ctx.layer_stats:
        return None
    heads = int(ctx.cell.cfg.get("heads", 1))
    L = len(ctx.layer_stats)
    need = sum(yardstick.bound_s(attention_bytes(ctx.layer_stats[i % L],
                                                 heads),
                                 attention_ops(ctx.layer_stats[i % L], heads))
               for i in range(len(durs)))
    return 100.0 * need / sum(durs)
