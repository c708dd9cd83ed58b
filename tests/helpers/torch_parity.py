"""Shared pieces of the port's parity tests against the JAX package: a
params tree with every leaf drawn from a numpy seed at a non-trivial
value (the JAX init zeros the LoRA b's, A_log, dt_bias, the norms and
the biases, which would leave whole terms untested), the tolerances, and
conversions, and the f32 oracle that holds bf16 results where the two
packages' bf16 roundings part."""
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

# f32: the whole-layer contract of tests/test_kernels.py:235; bf16: the
# 2e-2 of test_torch_transformer.py's bf16 logits and caches
TOL = {"float32": dict(atol=1e-4, rtol=3e-3),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def configs(jconfigs, tconfigs, arch, dtype="float32", **changes):
    """The JAX package's and the port's ``reduced()`` config of ``arch``
    in ``dtype``, with ``changes`` applied to both."""
    return tuple(dataclasses.replace(m.get_config(arch).reduced(),
                                     dtype=dtype, **changes)
                 for m in (jconfigs, tconfigs))


def _draw(path, leaf, rng):
    """A value for the leaf at ``path`` (its keys): normal(0.02) where the
    JAX init draws normal(0.02) (projections, embeddings, LoRA a's: logits
    of magnitude ~0.5, the premise of the bf16 tolerance), and a
    non-trivial spread around the constant the init sets otherwise."""
    name = path[-1]
    shape = leaf.shape
    if name == "A_log":                     # A = -exp(A_log) in [-2.7, -0.4]
        return rng.uniform(-1.0, 1.0, shape)
    if name == "dt_bias":
        return rng.normal(0.0, 0.5, shape)
    if name == "D_skip":
        return 1.0 + rng.normal(0.0, 0.2, shape)
    if name == "scale":                     # LayerNorm
        return 1.0 + rng.normal(0.0, 0.1, shape)
    if name == "conv":
        return rng.normal(0.0, 0.2, shape)
    if "norm" in name or name == "bias" or name in ("bq", "bk", "bv",
                                                   "b_in", "b_out"):
        return rng.normal(0.0, 0.1, shape)
    if name in ("b_q", "b_k", "b_v"):       # LoRA b's (the init's zeros)
        return rng.normal(0.0, 0.05, shape)
    return rng.normal(0.0, 0.02, shape)


def random_params(jparams, seed):
    """(the JAX tree, the same as numpy arrays for ``params_from_numpy``)
    with the structure, shapes and dtypes of ``jparams`` and every leaf
    drawn from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    leaves = []
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        leaves.append(jnp.asarray(_draw(keys, leaf, rng), leaf.dtype))
    jp = jax.tree_util.tree_unflatten(treedef, leaves)
    return jp, jax.tree.map(np.asarray, jp)


def to_np(x):
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_tree_close(got, want, tol, what=""):
    """Every leaf of the port's cache (dicts and ``SSMCache`` tuples)
    against the JAX package's, with the same structure, shapes and
    dtypes."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
        return
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__, what
        assert got._fields == want._fields, what
        for f in want._fields:
            assert_tree_close(getattr(got, f), getattr(want, f), tol,
                              f"{what}.{f}")
        return
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    np.testing.assert_allclose(to_np(got), to_np(want), err_msg=what, **tol)



def tree_leaves(tree, what=""):
    """(path, leaf) of a cache: dicts and ``SSMCache`` tuples."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k], f"{what}.{k}")
    elif isinstance(tree, tuple):
        for f in tree._fields:
            yield from tree_leaves(getattr(tree, f), f"{what}.{f}")
    else:
        yield what, tree


def f32_oracle(jtf, jc, jp, batch, **kw):
    """``repro``'s prefill in f32 on ``jp`` and ``batch`` (bf16 values,
    taken exactly into f32): the exact result the bf16 runs round.
    Returns what ``forward`` returns for ``kw``."""
    f32 = lambda t: (jnp.asarray(t, jnp.float32)
                     if jnp.issubdtype(jnp.asarray(t).dtype, jnp.floating)
                     else t)
    return jtf.forward(dataclasses.replace(jc, dtype="float32"),
                       jax.tree.map(f32, jp),
                       {k: f32(v) for k, v in batch.items()},
                       mode="prefill", remat=False, **kw)


def assert_no_farther_from_oracle(got, want, oracle, what=""):
    """The port's bf16 ``got`` is no farther from the f32 ``oracle`` than
    ``repro``'s bf16 ``want``: the max and the 99.9th percentile of
    |error|, each no larger."""
    o = to_np(oracle).ravel()
    g, w = np.abs(to_np(got).ravel() - o), np.abs(to_np(want).ravel() - o)
    gq, wq = np.quantile(g, 0.999), np.quantile(w, 0.999)
    assert g.max() <= w.max() and gq <= wq, (
        f"{what}: port max {g.max()} p99.9 {gq}; repro max {w.max()} "
        f"p99.9 {wq}")
