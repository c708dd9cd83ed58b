"""``sample_s``: the port's ``sample_layer_graphs`` call, by the
harness's clock around it."""


def read(ctx):
    return ctx.timings["sample_s"]
