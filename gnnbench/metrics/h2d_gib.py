"""``h2d_gib``: the GiB an epoch copies from host memory to the card in
the port's binding: the ``bytes`` of the trace's ``Memcpy HtoD`` copies
whose runtime call was issued inside an ``io.*`` range (the port counts
the same bytes in its ``io.h2d_bytes`` counter), over the traced epochs
(after the profiler's first), per epoch.  None where the trace holds no
``io.*`` range; 0 where nothing is copied to a card (the CPU)."""
from gnnbench import iotrace


def read(ctx):
    got = iotrace.read(ctx)
    return None if got is None else got.h2d_bytes / 2 ** 30
