"""``nodes_per_s``: the nodes embedded in the window's whole epochs over
the window's elapsed time, all the work over all the time (host clock;
each epoch ends in a device synchronize)."""


def read(ctx):
    return len(ctx.epochs_s) * ctx.n_nodes / ctx.window_s
