"""``gat_attention_roofline``: the ``gat_attention`` kernel's launches in
the traced epochs (``scores_kernel`` or ``wide_kernel`` of
``csrc/gat_attention.cu`` with the softmax), their least time by the
yardstick over their device time, in %.  The i-th launch is layer
i mod L's scores, over that layer's output width."""
import re

from gnnbench import yardstick

KERNEL = re.compile(r"(scores_kernel|wide_kernel)<[^()]*true>")


def read(ctx):
    durs = [d for name, d in ctx.trace.get("kernels", ())
            if KERNEL.search(name)]
    if not durs or not ctx.layer_stats:
        return None
    cfg = ctx.cell.cfg
    heads = int(cfg.get("heads", 1))
    D = [do for _, do in yardstick.layer_widths(cfg)]
    L = len(ctx.layer_stats)
    need = sum(yardstick.bound_s(
        yardstick.gat_attention_bytes(ctx.layer_stats[i % L], D[i % L],
                                      heads),
        yardstick.kernel_flops(ctx.layer_stats[i % L], D[i % L]))
        for i in range(len(durs)))
    return 100.0 * need / sum(durs)
