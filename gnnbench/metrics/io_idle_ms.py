"""``io_idle_ms``: the ms an epoch the device is idle while the host is
in the port's binding: the idle gaps of the traced epochs (after the
profiler's first) whose middle lies in an ``io.*`` range, the innermost
port range there (``iotrace.idle_by_span``), summed over the epochs'
count.  None where the trace holds no ``io.*`` range."""
from gnnbench import iotrace


def read(ctx):
    got = iotrace.read(ctx)
    return None if got is None else got.io_idle_s * 1e3
