"""``bind_prepare_ms``: the ms an epoch spends outside the executor ops:
the ``DenseIO`` build of each layer graph with its mean weights,
``CudaExecutor.prepare`` (the features' copy to the card) and the
activations; the epoch's wall time less ``ops_ms``'s time.  The mean
over the epochs run under spans after the window."""
import statistics


def read(ctx):
    if not ctx.span_epochs:
        return None
    return statistics.fmean(e["wall_s"] - (e["ops_s"] - e["bind_in_ops_s"])
                            for e in ctx.span_epochs) * 1e3
