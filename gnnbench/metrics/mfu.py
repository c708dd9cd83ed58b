"""``mfu``: the model FLOPs of the window's epochs over the window's
time and the card's f32 peak (67 TFLOP/s: the GEMMs run in f32 with
TF32 off), in %.  FLOPs come from each layer's widths and its layer
graph's live slots, or as the model's reference declares them
(``yardstick.epoch_flops``)."""
from gnnbench import yardstick


def read(ctx):
    if not ctx.layer_stats:
        return None
    cfg = ctx.cell.cfg
    flops = yardstick.epoch_flops(cfg["model"], ctx.n_nodes,
                                  yardstick.layer_widths(cfg),
                                  ctx.layer_stats, cfg)
    rate = flops * len(ctx.epochs_s) / ctx.window_s
    return 100.0 * rate / yardstick.PEAK_FLOPS_F32
