"""``spmm_roofline``: the ``spmm`` kernel's launches in the traced epochs
(``spmm_kernel`` of ``csrc/spmm.cu``), their least time by the
yardstick over their device time, in %.  The i-th launch of the window
is layer i mod L's aggregation (GAT: its attend, weighed per head), at
that layer's ``yardstick.slot_width``."""
from gnnbench import yardstick

KERNEL = "spmm_kernel<"


def read(ctx):
    durs = [d for name, d in ctx.trace.get("kernels", ()) if KERNEL in name]
    if not durs or not ctx.layer_stats:
        return None
    cfg = ctx.cell.cfg
    heads = int(cfg.get("heads", 1))
    D = [yardstick.slot_width(cfg["model"], di, do)
         for di, do in yardstick.layer_widths(cfg)]
    L = len(ctx.layer_stats)
    need = sum(yardstick.bound_s(
        yardstick.spmm_bytes(ctx.layer_stats[i % L], D[i % L], heads),
        yardstick.kernel_flops(ctx.layer_stats[i % L], D[i % L]))
        for i in range(len(durs)))
    return 100.0 * need / sum(durs)
