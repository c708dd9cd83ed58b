"""Checkpoints in the JAX package's npz layout (``repro.train.checkpoint``):
a checkpoint written by either package restores in the other.

Keys are the JAX params tree's paths joined by "::" under "params::"
(each layer stack as one array with its leading layer axes, as
``models.transformer.params_to_numpy`` gives it) and the optimizer
state's under "opt::" ("opt::.step", "opt::.m::<path>",
"opt::.v::<path>": ``repro``'s ``_flatten`` of its ``OptState``); bf16
is stored as f32 (npz has no bf16); ``__step__`` and ``__meta__`` (JSON)
beside them.  Restoring writes into the parameters and moments it is
given, cast to their dtypes, and returns them.

Params and state placed on a mesh (``sharding.placement``) are gathered
to the CPU to be saved, so the file is the same whichever mesh wrote it;
``restore_checkpoint(..., mesh=)`` places what it restores by the
sharding rules, as JAX's ``sharding=`` does.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.models.transformer import jax_layout, params_to_numpy
from repro_torch.sharding.placement import (gather_tree, has_placed,
                                            place_module, place_tree)
from repro_torch.sharding.specs import param_specs
from repro_torch.train.optimizer import OptState

_SEP = "::"


def _flatten(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, pre + (k,))
        else:
            yield _SEP.join(pre + (k,)), v


def save_checkpoint(path, params, opt_state: Optional[OptState] = None,
                    step: int = 0, metadata: Optional[dict] = None, *, cfg):
    """``params``: the ``LM`` of ``cfg``; ``opt_state``: its
    ``OptState``; either may be placed."""
    if has_placed(params):
        params = gather_tree(params, "cpu")
        opt_state = (None if opt_state is None
                     else gather_tree(opt_state, "cpu"))
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blobs = {f"params{_SEP}{k}": v
             for k, v in _flatten(params_to_numpy(cfg, params))}
    if opt_state is not None:
        blobs[f"opt{_SEP}.step"] = np.asarray(int(opt_state.step), np.int32)
        for name, moments in ((".m", opt_state.m), (".v", opt_state.v)):
            blobs.update({f"opt{_SEP}{name}{_SEP}{k}": v for k, v in
                          _flatten(params_to_numpy(cfg, moments))})
    np.savez(path, __step__=np.int64(step),
             __meta__=json.dumps(metadata or {}), **blobs)


def _fill(z, prefix, cfg, named):
    with torch.no_grad():
        for path, e in jax_layout(cfg).items():
            arr = z[prefix + _SEP + _SEP.join(path)]
            for idx, n in zip(np.ndindex(*e.lead), e.names):
                t = named[n]
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr[idx])).to(
                    t.dtype))


def restore_checkpoint(path, params_like, opt_like: Optional[OptState] = None,
                       *, cfg, mesh=None):
    """Restore into ``params_like`` (an ``LM`` of ``cfg``) and
    ``opt_like`` (its ``OptState``), in place.  Returns (params, step) or
    (params, opt_state, step).  With ``mesh``, the restored params and
    state are then placed on it by ``sharding.param_specs`` (JAX's
    ``sharding=``)."""
    z = np.load(path, allow_pickle=False)
    step = int(z["__step__"])
    _fill(z, "params", cfg, dict(params_like.named_parameters()))
    specs = None if mesh is None else param_specs(cfg, params_like, mesh)
    if opt_like is not None:
        _fill(z, f"opt{_SEP}.m", cfg, opt_like.m)
        _fill(z, f"opt{_SEP}.v", cfg, opt_like.v)
        opt_like.step.fill_(int(z[f"opt{_SEP}.step"]))
        if mesh is not None:
            opt_like = place_tree(opt_like, OptState((), specs, specs), mesh)
    if mesh is not None:
        params_like = place_module(params_like, specs, mesh)
    if opt_like is None:
        return params_like, step
    return params_like, opt_like, step
