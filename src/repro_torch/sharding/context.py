"""The ambient mesh — the twin of ``repro.sharding.context``.

``sharding_context(mesh)`` sets the mesh that the model code reads with
``current_mesh()``: ``models.moe.moe_block`` takes its expert-parallel
path and ``models.transformer``'s GQA decode its sequence-parallel path
there when their ``tuning`` flags are on.  Launchers wrap their steps in
it; tests and single-device runs never set it.

JAX's ``constrain`` is not ported: it is a hint to XLA's partitioner
that changes no value, and the port has no partitioner.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.sharding.specs import logical_axes

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh):
    token = _CTX.set({"mesh": mesh, "axes": logical_axes(mesh)})
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx["mesh"]
