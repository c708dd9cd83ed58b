"""``construct_s``: the port's ``csr_from_edges_distributed`` call, by
the harness's clock around it."""


def read(ctx):
    return ctx.timings["construct_s"]
