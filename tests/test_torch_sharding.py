"""The port's sharding rules and abstract trees against the JAX
package's, at full width, for every architecture.

``repro_torch.sharding.specs`` runs JAX's rules over the port's own
trees: the params' specs equal JAX's leaf for leaf through
``transformer.jax_layout`` (with the leading layer entries JAX's stacked
leaves carry dropped), and the cache and batch specs equal JAX's on the
same trees, on both production meshes and under each tuning flag that
switches a rule.  JAX is given a duck mesh (``axis_names`` and
``shape``: all its rules read), so no 256-device JAX is needed.  The
abstract trees (``abstract_params``, ``abstract_cache``,
``abstract_opt_state``, ``input_specs``) match JAX's ``eval_shape``
trees in shape and dtype with every leaf on the meta device, and
``per_chip_bytes`` equals the same sum over JAX's trees and specs."""
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
FLAGS = ["", "serve_tp", "gqa_cache_seq", "mla_cache_seq"]
CACHE_SHAPES = ("decode_32k", "long_500k")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tests share the CPU with other
    pytest workers, where PyTorch's OpenMP threads spin while they
    wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _duck(kind):
    shape = MESHES[kind]
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _tmesh(kind):
    return make_production_mesh(multi_pod=kind == "multi")


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX's eval_shape params, the port's meta params) at full width."""
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    return jtf.abstract_params(jc), ttf.abstract_params(tc)


def _shapes(arch):
    return [s.name for s in tconfigs.applicable_shapes(
        tconfigs.get_config(arch))]


def _enc(cfg):
    return cfg.n_frontend_tokens if cfg.family == "audio" else None


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    sh = tconfigs.get_shape(shape_name)
    return (jtf.abstract_cache(jc, sh.global_batch, sh.seq_len, _enc(jc)),
            ttf.abstract_cache(tc, sh.global_batch, sh.seq_len, _enc(tc)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_pairs(jtree, ttree):
    """(JAX leaf, port leaf) over a dict / NamedTuple tree of the same
    structure (caches, batches, their specs)."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), (set(jtree), set(ttree))
        for k in jtree:
            yield from _leaf_pairs(jtree[k], ttree[k])
    elif hasattr(jtree, "_fields"):
        assert jtree._fields == ttree._fields
        for a, b in zip(jtree, ttree):
            yield from _leaf_pairs(a, b)
    else:
        yield jtree, ttree


def _spec_eq(jspec, tspec):
    return tuple(jspec) == tuple(tspec)


def _jax_bytes(tree, specs, mesh):
    """JAX's trees: each leaf's bytes over its sharded axes' sizes."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= mesh.shape[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_specs_equal_jax_leaf_for_leaf(arch, mesh_kind, flag, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING", flag)
    jm, tm = _duck(mesh_kind), _tmesh(mesh_kind)
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp, tp = _params(arch)
    jps = jspecs.param_specs(jc, jp, jm)
    tps = tspecs.param_specs(tc, tp, tm)
    names = []
    for path, e in ttf.jax_layout(tc).items():
        js = tuple(_at(jps, path))
        assert js[:len(e.lead)] == (None,) * len(e.lead), path
        for n in e.names:
            assert tps[n] == js[len(e.lead):], (path, n, tps[n], js)
        names += e.names
    assert sorted(names) == sorted(tps)
    assert tspecs.per_chip_bytes(tp, tps, tm) == _jax_bytes(jp, jps, jm)
    n_caches = 0
    for shape_name in CACHE_SHAPES:
        if shape_name not in _shapes(arch):
            continue
        sh = tconfigs.get_shape(shape_name)
        jsh = jconfigs.get_shape(shape_name)
        jcache, tcache = _caches(arch, shape_name)
        jcs = jspecs.cache_specs(jc, jcache, jm, jsh)
        tcs = tspecs.cache_specs(tc, tcache, tm, sh)
        pairs = list(_leaf_pairs(jcs, tcs))
        assert pairs and all(_spec_eq(a, b) for a, b in pairs), pairs
        assert (tspecs.per_chip_bytes(tcache, tcs, tm)
                == _jax_bytes(jcache, jcs, jm))
        n_caches += 1
    assert n_caches == (2 if "long_500k" in _shapes(arch) else 1)
    for shape_name in _shapes(arch):
        sh = tconfigs.get_shape(shape_name)
        jsh = jconfigs.get_shape(shape_name)
        jb = jinputs.input_specs(jc, jsh)
        tb = tinputs.input_specs(tc, sh)
        jbs = jspecs.batch_specs(jc, jb, jm, jsh)
        tbs = tspecs.batch_specs(tc, tb, tm, sh)
        assert all(_spec_eq(a, b) for a, b in _leaf_pairs(jbs, tbs))
        assert tspecs.per_chip_bytes(tb, tbs, tm) == _jax_bytes(jb, jbs, jm)


def _same_leaf(j, t):
    assert t.is_meta
    assert tuple(t.shape) == tuple(j.shape), (t.shape, j.shape)
    assert t.dtype == _DT[np.dtype(j.dtype).name], (t.dtype, j.dtype)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_trees_match_jax_eval_shape(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp, tp = _params(arch)
    named = dict(tp.named_parameters())
    for path, e in ttf.jax_layout(tc).items():
        j = _at(jp, path)
        assert tuple(j.shape[:len(e.lead)]) == e.lead
        for n in e.names or [e.proto]:
            _same_leaf(SimpleNamespace(shape=j.shape[len(e.lead):],
                                       dtype=j.dtype), named[n])
    state = "bfloat16" if tc.param_count() > 1e11 else "float32"
    jo = jopt.abstract_opt_state(jp, jopt.AdamWConfig(state_dtype=state))
    to = topt.abstract_opt_state(tp, topt.AdamWConfig(state_dtype=state))
    _same_leaf(jo.step, to.step)
    for path, e in ttf.jax_layout(tc).items():
        for n in e.names:
            for jt, tt in ((jo.m, to.m), (jo.v, to.v)):
                j = _at(jt, path)
                _same_leaf(SimpleNamespace(shape=j.shape[len(e.lead):],
                                           dtype=j.dtype), tt[n])
    with pytest.raises(ValueError, match="meta"):
        topt.abstract_opt_state({"w": torch.zeros(2)}, topt.AdamWConfig())
    for shape_name in _shapes(arch):
        sh = tconfigs.get_shape(shape_name)
        pairs = list(_leaf_pairs(
            jinputs.input_specs(jc, jconfigs.get_shape(shape_name)),
            tinputs.input_specs(tc, sh)))
        assert pairs
        for j, t in pairs:
            _same_leaf(j, t)
        if shape_name in CACHE_SHAPES:
            for j, t in _leaf_pairs(*_caches(arch, shape_name)):
                _same_leaf(j, t)


def test_abstract_params_share_init_params_shapes_and_names():
    """``abstract_params`` is ``init_params``' code on the meta device:
    the same names, shapes and dtypes (reduced configs, every family)."""
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch).reduced()
        real = dict(ttf.init_params(cfg, 0, device="cpu").named_parameters())
        meta = dict(ttf.abstract_params(cfg).named_parameters())
        assert list(real) == list(meta), arch
        assert all(real[n].shape == meta[n].shape
                   and real[n].dtype == meta[n].dtype and meta[n].is_meta
                   for n in real), arch
        real_c = ttf.init_cache(cfg, 2, 8, device="cpu")
        meta_c = ttf.abstract_cache(cfg, 2, 8)
        for a, b in _leaf_pairs(real_c, meta_c):
            assert a.shape == b.shape and a.dtype == b.dtype and b.is_meta


def test_logical_axes_and_divisibility_guard():
    single, multi = _tmesh("single"), _tmesh("multi")
    assert tspecs.logical_axes(single) == jspecs.logical_axes(
        _duck("single"))
    assert tspecs.logical_axes(multi) == jspecs.logical_axes(_duck("multi"))
    for dim, axes in ((51865, ("model",)), (4096, ("pod", "data")),
                      (16, ("data",)), (8, ("data",)), (64, None)):
        assert (tspecs.shard_if_divisible(multi, dim, axes)
                == jspecs.shard_if_divisible(_duck("multi"), dim, axes))
    assert single.size == 256 and multi.size == 512
    assert single.axis_names == ("data", "model")
    assert multi.axis_names == ("pod", "data", "model")
