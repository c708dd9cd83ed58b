"""``ops_ms``: the ms an epoch spends in the port's executor ops: its
``ops.*`` spans (``core.ops.run_layer``; each op's span synchronizes
the device) less the binding's work inside them (the ``bind.mean_w``
probe: ``DenseIO`` builds its mean weights lazily, at the first spmm
of a layer).  The mean over the epochs run under spans after the
window."""
import statistics


def read(ctx):
    if not ctx.span_epochs:
        return None
    return statistics.fmean(e["ops_s"] - e["bind_in_ops_s"]
                            for e in ctx.span_epochs) * 1e3
