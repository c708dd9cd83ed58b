"""``sharding.placement`` on meshes whose shards are all ``cpu``: for
smollm-360m, zamba2-7b and deepseek-v2 ``reduced()``, on 4 x 1, 2 x 2,
1 x 4 and 4 x 2, the block of every param, AdamW moment and cache leaf
on each device is JAX's ``NamedSharding(mesh, PartitionSpec(*spec))
.devices_indices_map(shape)`` (computed in a subprocess over 8 forced
host devices, as ``tests/helpers/tuned_check.py`` runs JAX's mesh
paths; the port keeps each layer apart, so a stacked layer axis is not
there to compare), each shard holds ``per_chip_bytes``, ``gather`` of a
placed tensor is the tensor bitwise, replicas are storage of their own,
and after a decode step and a train step every replica equals its home
copy bitwise."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.sharding.context import sharding_context  # noqa: E402
from repro_torch.train import optimizer as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ("smollm-360m", "zamba2-7b", "deepseek-v2-236b")
MESHES = ((4, 1), (2, 2), (1, 4), (4, 2))
ROOT = os.path.join(os.path.dirname(__file__), "..")

_JAX_SIDE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    cases = json.load(sys.stdin)
    devs = jax.devices()
    out = []
    for names, shape_, items in cases:
        n = int(np.prod(shape_))
        mesh = Mesh(np.array(devs[:n]).reshape(shape_), tuple(names))
        order = {d: i for i, d in enumerate(mesh.devices.flat)}
        res = []
        for shape, spec in items:
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            m = NamedSharding(mesh, PartitionSpec(*spec)) \\
                .devices_indices_map(tuple(shape))
            rng = [None] * n
            for d, idx in m.items():
                rng[order[d]] = [list(s.indices(dim))[:2]
                                 for s, dim in zip(idx, shape)]
            res.append(rng)
        out.append(res)
    json.dump(out, sys.stdout)
""")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch, mesh, seq=16):
    """(params, OptState, decode cache at B=1, cache at B=4), each with
    its specs on ``mesh``."""
    cfg = tconfigs.get_config(arch).reduced()
    params = ttf.init_params(cfg, 0, device="cpu")
    pspecs = tspecs.param_specs(cfg, params, mesh)
    opt = toptim.init_opt_state(params, toptim.AdamWConfig())
    out = [(params, pspecs), (opt, toptim.OptState((), pspecs, pspecs))]
    for B in (1, 4):
        cache = ttf.init_cache(cfg, B, seq, device="cpu")
        shape = tconfigs.InputShape("c", seq, B, "decode")
        out.append((cache, tspecs.cache_specs(cfg, cache, mesh, shape)))
    return cfg, out


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_block_ranges_are_jaxs_devices_indices_map():
    """Every (shape, spec) of every leaf of the three archs' trees on
    the four meshes, and a ("pod", "data", "model") 2 x 2 x 2 mesh with
    a two-axis entry (the first axis the major one), against JAX's
    index maps."""
    cases, want = [], []
    for P, M in MESHES:
        mesh = make_host_mesh(P, M, device="cpu")
        items = {}
        for arch in ARCHS:
            _, trees = _trees(arch, mesh)
            for tree, specs in trees:
                for t, s in tspecs._pairs(tree, specs):
                    items[(tuple(t.shape), tuple(map(str, s)))] = (
                        list(t.shape), _spec_json(s))
        cases.append((["data", "model"], [P, M], list(items.values())))
        want.append([placement.block_ranges(sh, tuple(
            tuple(e) if isinstance(e, list) else e for e in sp), mesh)
            for sh, sp in items.values()])
    pod = AbstractMesh({"pod": 2, "data": 2, "model": 2})
    items = [([8, 6], [["pod", "data"], "model"]), ([4, 8, 2], [None, [
        "data", "pod"], "model"]), ([16], [["pod", "data", "model"]])]
    cases.append((list(pod.axis_names), [2, 2, 2], items))
    want.append([placement.block_ranges(sh, tuple(
        tuple(e) if isinstance(e, list) else e for e in sp), pod)
        for sh, sp in items])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    n = 0
    for (names, shape, items), jax_res, ours in zip(cases, got, want):
        for (sh, sp), j, o in zip(items, jax_res, ours):
            assert [[list(r) for r in dev] for dev in o] == j, (
                names, shape, sh, sp)
            n += 1
    assert n > 40


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_each_shard_holds_per_chip_bytes_and_gathers_bitwise(arch, shape):
    mesh = make_host_mesh(*shape, device="cpu")
    _, trees = _trees(arch, mesh)
    for tree, specs in trees:
        if not isinstance(tree, torch.nn.Module):    # caches: non-zero
            gen = torch.Generator().manual_seed(0)
            for t, _ in tspecs._pairs(tree, specs):
                t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
        placed = placement.place_tree(tree, specs, mesh)
        want = tspecs.per_chip_bytes(tree, specs, mesh)
        assert placement.shard_bytes(placed) == [want] * (shape[0]
                                                          * shape[1])
        assert placement.device_bytes(placed) == {
            torch.device("cpu"): want * shape[0] * shape[1]}
        ptrs = set()
        for (t, _), x in zip(tspecs._pairs(tree, specs),
                             placement._leaves(placed)):
            assert torch.equal(placement.gather(x, "cpu"), t)
            assert x.dtype == t.dtype and x.shape == t.shape
            for b in x.blocks:      # every block, replicas too, its own
                assert b.data_ptr() not in ptrs or b.numel() == 0
                ptrs.add(b.data_ptr())


def test_place_blocks_draws_each_block_on_its_device():
    mesh = make_host_mesh(4, 1, device="cpu")

    def make(i, shape, dev):
        return torch.randn(shape, generator=torch.Generator(
            device=dev).manual_seed(i), device=dev)

    x = placement.place_blocks((1, 32, 2, 8), torch.float32,
                               (None, "data", None, None), mesh, make)
    full = placement.gather(x)
    for i in range(4):
        want = make(i, (1, 8, 2, 8), "cpu")
        assert torch.equal(full[:, 8 * i:8 * (i + 1)], want)
    with pytest.raises(ValueError, match="block 0"):
        placement.place_blocks((1, 32, 2, 8), torch.float32,
                               (None, "data", None, None), mesh,
                               lambda i, s, d: torch.zeros(s[1:]))


def _replicas_equal(tree):
    n = 0
    for x in placement._leaves(tree):
        home = {}
        for blk, rng in zip(x.blocks, x.ranges):
            if rng in home:
                n += 1
            assert torch.equal(blk, home.setdefault(rng, blk)), x
    return n


def test_replicas_stay_equal_after_a_decode_step(monkeypatch):
    """zamba2 reduced, B=1, on 2 x 2 under cp_decode: the SSM conv and
    state are replicated on all four shards, the k and v caches over
    ``model`` (the head dim over 2 shards, each block on two data rows
    apart); after two steps every replica is its home copy, bitwise."""
    cfg = dataclasses.replace(tconfigs.get_config("zamba2-7b").reduced(),
                              dtype="float32")
    params = ttf.init_params(cfg, 0, device="cpu")
    mesh = make_host_mesh(2, 2, device="cpu")
    cache = ttf.init_cache(cfg, 1, 16, device="cpu")
    specs = tspecs.cache_specs(cfg, cache, mesh, tconfigs.InputShape(
        "d", 16, 1, "decode"))
    placed = placement.place_tree(cache, specs, mesh)
    pparams = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    monkeypatch.setenv("REPRO_TUNING", "cp_decode")
    with sharding_context(mesh):
        for t in range(2):
            ttf.decode_step(cfg, pparams, placed,
                            {"token": torch.tensor([[3 + t]]), "pos": t})
    assert _replicas_equal(placed) > 0
    assert bool(placed["mamba"].state.blocks[3].abs().sum() > 0)
    assert _replicas_equal(pparams) > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_replicas_stay_equal_after_a_train_step(arch):
    """Two data-parallel steps on 2 x 2: every replicated block of the
    params, m, v and the step counter equals its home copy bitwise."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype="float32")
    mesh = make_host_mesh(2, 2, device="cpu")
    params = ttf.init_params(cfg, 0, device="cpu")
    specs = tspecs.param_specs(cfg, params, mesh)
    opt = placement.place_tree(
        toptim.init_opt_state(params, toptim.AdamWConfig()),
        toptim.OptState((), specs, specs), mesh)
    params = placement.place_module(params, specs, mesh)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (4, 16)))
                 for k in ("tokens", "labels")}
        with sharding_context(mesh):
            params, opt, metrics = tstep.train_step(
                cfg, toptim.AdamWConfig(), params, opt, batch,
                attn_backend="ref")
    assert np.isfinite(float(metrics["loss"]))
    assert _replicas_equal(params) > 0 and _replicas_equal(opt) > 0
    assert [int(b) for b in opt.step.blocks] == [2] * 4
