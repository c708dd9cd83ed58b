"""``io_ms``: the ms an epoch spends in the port's binding, timed where
it happens: the port's ``io.*`` spans (``core.ops``: ``DenseIO``'s
build, its mean weights, ``prepare``), read as the ``record_function``
ranges they open in the profiler's trace, summed over the traced epochs
(after the profiler's first) over their count.  None where the trace
holds no ``io.*`` range."""
from gnnbench import iotrace


def read(ctx):
    got = iotrace.read(ctx)
    return None if got is None else got.io_s * 1e3
