"""Logical-axis rules for both production meshes — the twin of
``repro.sharding.specs``, over the port's own trees.

Tokens and batch ("graph rows") shard over ``data`` (P), features, heads
and experts ("feature columns") over ``model`` (M); on the 2-pod mesh
``pod`` joins the data-parallel and FSDP groups.  Every rule is
divisibility-guarded: a dimension that does not divide evenly over its
axes stays unsharded (whisper's 51865 vocab).

A spec is a tuple with one entry per dimension: None, an axis name, or
a tuple of axis names, as a ``PartitionSpec``'s entries.  A mesh is
anything with ``axis_names`` and ``shape`` ({axis: size}):
``launch.mesh.Mesh`` or ``AbstractMesh``.

- ``param_specs`` returns {parameter name: spec} for
  ``named_parameters()``.  The JAX tree stacks each layer stack along a
  leading axis that its rules leave None; the port keeps layers apart.
  So each rule runs on the JAX leaf it fills, found through
  ``models.transformer.jax_layout`` (its path and its stacked shape),
  and the spec drops the leading layer entries.  The MoE rule keys on a
  ``"moe"`` entry of that JAX path.
- ``cache_specs`` and ``batch_specs`` map the port's cache and batch
  trees (dicts, ``SSMCache``) to specs of the same structure.  A leaf's
  name is its last dict key, as ``_leaf_name`` reads JAX's paths: the
  ``conv`` and ``state`` of an ``SSMCache`` under "ssm" are named "ssm",
  so the cache rules for "conv" and "state" match no leaf, in either
  package.
- ``per_chip_bytes`` sums each leaf's bytes over the product of its
  sharded axes' sizes.

The ``serve_tp``, ``gqa_cache_seq`` and ``mla_cache_seq`` flags of
``tuning`` switch the rules as they do the JAX package's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import tuning
from repro_torch.configs.base import InputShape, ModelConfig

Spec = Tuple[Any, ...]


def logical_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    """dp / fsdp / tp mesh-axis groups for a production mesh."""
    if "pod" in mesh.axis_names:
        return {"dp": ("pod", "data"), "fsdp": ("pod", "data"),
                "tp": ("model",)}
    return {"dp": ("data",), "fsdp": ("data",), "tp": ("model",)}


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def shard_if_divisible(mesh, dim: int, axes: Optional[Tuple[str, ...]]):
    """The axes (a spec entry) iff ``dim`` divides evenly over them."""
    if axes is None:
        return None
    if dim % _axis_size(mesh, axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

_COL_PARALLEL = {  # (in, out) -> (fsdp, tp): contract dim fsdp, out dim tp
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_xz", "w_bc", "w_dt",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "a_q", "a_k", "a_v", "router",
    "projector", "shared_w_gate", "shared_w_up", "lm_head",
}
_ROW_PARALLEL = {  # (in, out) -> (tp, fsdp): contract dim tp, out dim fsdp
    "wo", "w_down", "w_out", "shared_w_down",
}
_MOE_EXPERT = {"w_gate", "w_up", "w_down"}  # with a leading E dim
_LORA_B = {"b_q", "b_k", "b_v"}


def _param_rule(mesh, path: Tuple[str, ...], shape, fsdp, tp) -> Spec:
    """The JAX package's rule for the leaf at ``path`` of its params tree,
    of ``shape`` (leading layer axes included)."""
    name = path[-1]
    nd = len(shape)
    lead = (None,) * max(nd - 2, 0)
    if name == "embed":
        return (shard_if_divisible(mesh, shape[0], tp),
                shard_if_divisible(mesh, shape[1], fsdp))
    if name in _MOE_EXPERT and "moe" in path and nd >= 3:
        lead = (None,) * (nd - 3)
        e, d1, d2 = shape[-3:]
        if name == "w_down":   # (E, F, D)
            return (*lead, shard_if_divisible(mesh, e, tp), None,
                    shard_if_divisible(mesh, d2, fsdp))
        return (*lead, shard_if_divisible(mesh, e, tp),
                shard_if_divisible(mesh, d1, fsdp), None)
    if name in _COL_PARALLEL and nd >= 2:
        return (*lead, shard_if_divisible(mesh, shape[-2], fsdp),
                shard_if_divisible(mesh, shape[-1], tp))
    if name in _ROW_PARALLEL and nd >= 2:
        return (*lead, shard_if_divisible(mesh, shape[-2], tp),
                shard_if_divisible(mesh, shape[-1], fsdp))
    if name in _LORA_B and nd >= 2:
        return (*lead, None, shard_if_divisible(mesh, shape[-1], tp))
    if name == "conv" and nd >= 2:
        return (*lead, None, shard_if_divisible(mesh, shape[-1], tp))
    return (None,) * nd


def param_specs(cfg: ModelConfig, abstract, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} for ``abstract`` (``transformer.
    abstract_params(cfg)``, or any params ``LM`` of the config).

    With REPRO_TUNING=serve_tp the FSDP dim is left unsharded (weights
    replicated over ``data``, sharded over ``model`` only): the serving
    profile for models whose tp-sharded weights fit one chip."""
    from repro_torch.models.transformer import jax_layout
    ax = logical_axes(mesh)
    fsdp, tp = ax["fsdp"], ax["tp"]
    if tuning.on("serve_tp"):
        fsdp = None
    named = dict(abstract.named_parameters())
    specs = {}
    for path, e in jax_layout(cfg).items():
        for n in e.names:
            spec = _param_rule(mesh, path, e.lead + tuple(named[n].shape),
                               fsdp, tp)
            if any(s is not None for s in spec[:len(e.lead)]):
                raise AssertionError(f"{path}: a rule shards a layer axis")
            specs[n] = spec[len(e.lead):]
    return {n: specs[n] for n in named}


# ----------------------------------------------------------------------
# caches & batches
# ----------------------------------------------------------------------

def _map(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts and NamedTuples; ``name``
    is the leaf's last dict key."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, name) for v in tree))
    return fn(name, tree)


def cache_specs(cfg: ModelConfig, abstract_cache, mesh,
                shape: InputShape):
    """KV / state cache specs.  batch == 1 -> shard the sequence."""
    ax = logical_axes(mesh)
    dp, tp = ax["dp"], ax["tp"]
    seq_shard = shape.global_batch == 1

    def rule(name, leaf):
        shape_ = tuple(leaf.shape)
        nd = len(shape_)
        if name in ("k", "v", "cross_k", "cross_v"):
            lead = (None,) * (nd - 4)
            b, s, k, hd = shape_[-4:]
            if seq_shard:
                return (*lead, None, shard_if_divisible(mesh, s, ("data",)),
                        None, shard_if_divisible(mesh, hd, tp))
            # gqa_cache_seq: the cache's sequence over `model`, so decode
            # scores stay shard-local; the baseline shards head_dim
            if tuning.on("gqa_cache_seq"):
                return (*lead, shard_if_divisible(mesh, b, dp),
                        shard_if_divisible(mesh, s, tp), None, None)
            return (*lead, shard_if_divisible(mesh, b, dp), None, None,
                    shard_if_divisible(mesh, hd, tp))
        if name in ("c_kv", "k_rope", "first_c_kv", "first_k_rope"):
            lead = (None,) * (nd - 3)
            b, s, r = shape_[-3:]
            if seq_shard:
                return (*lead, None, shard_if_divisible(mesh, s, ("data",)),
                        shard_if_divisible(mesh, r, tp))
            # mla_cache_seq: the latent cache's sequence over `model`
            if tuning.on("mla_cache_seq"):
                return (*lead, shard_if_divisible(mesh, b, dp),
                        shard_if_divisible(mesh, s, tp), None)
            return (*lead, shard_if_divisible(mesh, b, dp), None,
                    shard_if_divisible(mesh, r, tp))
        if name == "conv":          # SSM conv window (..., B, W, C)
            lead = (None,) * (nd - 3)
            b, w, c = shape_[-3:]
            return (*lead, shard_if_divisible(mesh, b, dp), None,
                    shard_if_divisible(mesh, c, tp))
        if name == "state":         # SSM state (..., B, H, N, P)
            lead = (None,) * (nd - 4)
            b, h, n, pd = shape_[-4:]
            return (*lead, shard_if_divisible(mesh, b, dp),
                    shard_if_divisible(mesh, h, tp), None, None)
        return (None,) * nd

    return _map(rule, abstract_cache)


def batch_specs(cfg: ModelConfig, batch_abstract, mesh,
                shape: InputShape):
    """The batch's leading dim over the data-parallel axes; 0-d leaves
    (decode's "pos") replicated."""
    dp = logical_axes(mesh)["dp"]

    def rule(name, leaf):
        nd = leaf.dim()
        if nd == 0:
            return ()
        return (shard_if_divisible(mesh, leaf.shape[0], dp),
                *((None,) * (nd - 1)))

    return _map(rule, batch_abstract)


# ----------------------------------------------------------------------
# bytes a chip holds
# ----------------------------------------------------------------------

def _pairs(tree, specs):
    """(tensor, spec) of every leaf of ``tree``: params modules, dicts,
    (Named)tuples and tensors, ``specs`` of the same structure."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        for v, s in zip(tree, specs, strict=True):
            yield from _pairs(v, s)


def _shards(mesh, spec: Spec) -> int:
    n = 1
    for entry in spec:
        if entry is not None:
            n *= _axis_size(mesh, (entry,) if isinstance(entry, str)
                            else tuple(entry))
    return n


def per_chip_bytes(tree, specs, mesh) -> int:
    """Each leaf's bytes over the product of its sharded axes' sizes,
    summed: what one chip holds of ``tree``."""
    return sum(t.numel() * t.element_size() // _shards(mesh, s)
               for t, s in _pairs(tree, specs))
