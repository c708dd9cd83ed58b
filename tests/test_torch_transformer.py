"""The port's transformer (``repro_torch.models``: the dense family and
the moe family's two layouts, llama4-maverick and deepseek-v2 with MLA)
and its config copy against the JAX package: every config field for
field, the layers, ``params_from_numpy``, the prefill forward with its
cache, the decode step over several ragged steps, decode against teacher
forcing, and the clamped cache write.  Params are the JAX package's,
carried over as numpy by ``params_from_numpy``; inputs come from numpy
seeds; configs are ``reduced()``."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
import bf16_oracle  # noqa: E402

# f32: the whole-model tolerance of infer_all (tests/test_kernels.py:235).
# bf16: both packages round every projection, norm and residual to bf16,
# at the same points but through different matmul and transcendental
# code; one bf16 ulp is 2^-8 = 0.4% relative, and two layers of it on
# logits of magnitude ~0.5 stay within 2e-2.
TOL = {"float32": dict(atol=1e-4, rtol=3e-3),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DENSE = ["smollm-360m", "qwen2.5-14b", "gemma3-4b", "granite-8b"]
MOE = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]


def _cfg(arch, dtype="float32"):
    jc = dataclasses.replace(jconfigs.get_config(arch).reduced(), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_config(arch).reduced(), dtype=dtype)
    return jc, tc


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _model(arch, dtype="float32", seed=0):
    jc, tc = _cfg(arch, dtype)
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, ttf.params_from_numpy(tc, _numpy_tree(jp),
                                             device="cpu")


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------

def test_config_registry_matches_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ([dataclasses.asdict(s) for s in tconfigs.INPUT_SHAPES]
            == [dataclasses.asdict(s) for s in jconfigs.INPUT_SHAPES])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_jax_field_by_field(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert ([s.name for s in tconfigs.applicable_shapes(t)]
            == [s.name for s in jconfigs.applicable_shapes(j)])


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def pair(*shape, scale=1.0):
        j = jnp.asarray(rng.standard_normal(shape) * scale, jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    tol = TOL[dtype]
    xj, xt = pair(2, 6, 4, 32)
    sj, st = pair(32, scale=0.1)
    np.testing.assert_allclose(_np(tlayers.rms_norm(xt, st, 1e-5)),
                               _np(jlayers.rms_norm(xj, sj, 1e-5)), **tol)
    pos = np.arange(6)[None] + np.array([[0], [3]])
    for positions in (np.arange(6), pos):
        for theta in (10_000.0, 1_000_000.0):
            got = tlayers.rope(xt, torch.from_numpy(positions),
                               np.float32(theta))
            want = jlayers.rope(xj, jnp.asarray(positions),
                                jnp.float32(theta))
            assert got.dtype == tdt
            np.testing.assert_allclose(_np(got), _np(want), **tol)
    hj, ht = pair(2, 6, 32)
    (gj, gt), (uj, ut), (dj, dt) = pair(32, 48, scale=0.2), pair(
        32, 48, scale=0.2), pair(48, 32, scale=0.2)
    np.testing.assert_allclose(_np(tlayers.swiglu_mlp(ht, gt, ut, dt)),
                               _np(jlayers.swiglu_mlp(hj, gj, uj, dj)), **tol)
    ej, et = pair(50, 32)
    tok = rng.integers(0, 50, (2, 6))
    for scale in (None, 2560 ** 0.5):
        np.testing.assert_array_equal(
            _np(tlayers.embed_tokens(et, torch.from_numpy(tok), scale)),
            _np(jlayers.embed_tokens(ej, jnp.asarray(tok), scale)))


def test_layer_meta_matches_jax():
    for arch in DENSE:
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for jc, tc in ((j, t), (j.reduced(), t.reduced())):
            jw, jt = jtf.layer_meta(jc)
            tw, tt = ttf.layer_meta(tc)
            assert tw == np.asarray(jw).tolist()
            np.testing.assert_array_equal(np.float32(tt), np.asarray(jt))


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [("smollm-360m", "bfloat16"),
                                        ("qwen2.5-14b", "float32")])
def test_params_from_numpy_unstacks_the_layer_axis(arch, dtype):
    jc, tc, jp, tp = _model(arch, dtype)
    tree = _numpy_tree(jp)
    assert tp.embed.dtype == getattr(torch, dtype)
    assert not tp.embed.requires_grad
    np.testing.assert_array_equal(_np(tp.embed), _np(tree["embed"]))
    assert len(tp.blocks) == tc.n_layers
    for l, blk in enumerate(tp.blocks):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                _np(getattr(blk.attn, name)),
                _np(tree["blocks"]["attn"][name][l]))
        np.testing.assert_array_equal(_np(blk.mlp.w_down),
                                      _np(tree["blocks"]["mlp"]["w_down"][l]))
    assert (tp.lm_head is None) == tc.tie_embeddings
    assert (tp.blocks[0].attn.bq is not None) == tc.qkv_bias
    n = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tp.parameters()) == n


def test_params_from_numpy_refuses_another_shape():
    jc, tc, jp, _ = _model("smollm-360m")
    tree = _numpy_tree(jp)
    with pytest.raises(ValueError, match="keys"):
        ttf.params_from_numpy(tc, {**tree, "lm_head": tree["embed"]},
                              device="cpu")
    with pytest.raises(ValueError, match="layers"):
        ttf.params_from_numpy(dataclasses.replace(tc, n_layers=3), tree,
                              device="cpu")


def _jax_leaf(tree, name):
    """The JAX leaf behind a port parameter's name: "blocks.3.attn.wq" is
    tree["blocks"]["attn"]["wq"][3] (JAX stacks layers on axis 0)."""
    parts = name.split(".")
    if len(parts) == 1:
        return np.asarray(tree[parts[0]])
    leaf = tree[parts[0]]
    for k in parts[2:]:
        leaf = leaf[k]
    return np.asarray(leaf)[int(parts[1])]


@pytest.mark.parametrize("arch,dtype", [("deepseek-v2-236b", "bfloat16"),
                                        ("llama4-maverick-400b-a17b",
                                         "float32")])
def test_params_from_numpy_unstacks_the_moe_stacks(arch, dtype):
    """Every port parameter is its JAX leaf's layer, bit for bit, across
    deepseek-v2's first_blocks and blocks and llama4's super_blocks; no
    leaf is left over; another shape is refused."""
    jc, tc, jp, tp = _model(arch, dtype)
    tree = _numpy_tree(jp)
    stacks = ({"first_blocks", "blocks"} if tc.moe.first_dense_layers
              else {"super_blocks"})
    assert stacks <= set(tree) and all(hasattr(tp, n) for n in stacks)
    for name, t in tp.named_parameters():
        np.testing.assert_array_equal(_np(t), _np(_jax_leaf(tree, name)),
                                      err_msg=name)
        assert t.dtype == (torch.float32 if name.endswith("router")
                           else getattr(torch, dtype))
    n = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tp.parameters()) == n
    name = next(iter(stacks))
    bad = {**tree, name: {**tree[name], "extra": tree["final_norm"]}}
    with pytest.raises(ValueError, match="keys"):
        ttf.params_from_numpy(tc, bad, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        ttf.params_from_numpy(dataclasses.replace(tc, n_layers=4), tree,
                              device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_init_params_draws_the_moe_shapes_from_a_seed(arch):
    jc, tc = _cfg(arch, "bfloat16")
    shapes = jax.eval_shape(lambda: jtf.init_params(jc,
                                                    jax.random.PRNGKey(0)))
    a = ttf.init_params(tc, 1, device="cpu")
    names = dict(a.named_parameters())
    stacks = [k for k, v in shapes.items() if isinstance(v, dict)]
    assert len(names) == (len(shapes) - len(stacks)) + sum(
        leaf.shape[0] for k in stacks for leaf in jax.tree.leaves(shapes[k]))
    for name, t in names.items():
        parts = name.split(".")
        leaf = shapes[parts[0]]
        for k in parts[2:]:
            leaf = leaf[k]
        want = leaf.shape if len(parts) == 1 else leaf.shape[1:]
        assert tuple(t.shape) == tuple(want), name
    b = ttf.init_params(tc, 1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


@pytest.mark.parametrize("arch,item", [("llava-next-34b", 15)])
def test_other_families_name_the_roadmap_item(arch, item):
    """The last family (item 15: vlm) is ported: its params and cache
    build.  Queue 1's last item (placement across cards) is ported too:
    the training launcher takes a mesh over two cards, and refuses it
    only for CPU tensors, which are not on its home."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import Mesh
    cfg = tconfigs.get_config(arch).reduced()
    params = ttf.init_params(cfg, 0, device="cpu")
    assert tuple(params.projector.shape) == (cfg.frontend_dim, cfg.d_model)
    cache = ttf.init_cache(cfg, 1, 8, device="cpu")
    assert tuple(cache["k"].shape) == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                       cfg.resolved_head_dim)
    two_cards = Mesh(1, 2, [torch.device("cuda", 0),
                            torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="home on cuda:0, the tensors "
                                         "are on cpu$"):
        launch_train.run(arch, mesh=two_cards, device="cpu")


def test_init_params_draws_the_jax_shapes_from_a_seed():
    jc, tc = _cfg("qwen2.5-14b")
    a = ttf.init_params(tc, 1, device="cpu")
    b = ttf.init_params(tc, 1, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          jax.eval_shape(lambda: jtf.init_params(
                              jc, jax.random.PRNGKey(0))))
    assert tuple(a.blocks[1].attn.wq.shape) == shapes["blocks"]["attn"][
        "wq"][1:]
    assert tuple(a.embed.shape) == shapes["embed"]
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert float(a.blocks[0].attn.wq.std()) == pytest.approx(0.02, rel=0.1)
    assert float(a.blocks[0].attn.bq.abs().max()) == 0.0
    with pytest.raises(ValueError, match="forward mode 'decode'"):
        ttf.forward(tc, a, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    mode="decode")


# ----------------------------------------------------------------------
# prefill forward and decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [
    ("smollm-360m", "float32"), ("smollm-360m", "bfloat16"),
    ("qwen2.5-14b", "float32"), ("qwen2.5-14b", "bfloat16"),
    ("gemma3-4b", "float32"), ("granite-8b", "float32"),
    ("deepseek-v2-236b", "float32"),
    ("llama4-maverick-400b-a17b", "float32")])
def test_prefill_forward_and_cache_match_jax(arch, dtype):
    """Logits, the aux loss (0 for dense; the MoE layers' Switch loss)
    and every cache entry (dense and llama4: k and v; deepseek-v2: MLA's
    four latent caches)."""
    jc, tc, jp, tp = _model(arch, dtype, seed=2)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40))
    want, jaux, jcache = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                                     mode="prefill", return_cache=True,
                                     remat=False)
    kops.reset_launch_counts()
    got, aux, cache = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                                  mode="prefill", return_cache=True)
    assert kops.launch_counts()["flash_attention"] == 0      # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (2, 40, tc.vocab_size)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), **TOL[dtype])
    assert (float(aux) == 0.0) == (tc.moe is None)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert set(cache) == set(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        assert cache[name].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL[dtype])
    hidden, _ = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                            return_hidden=True)
    jh, _ = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                        mode="prefill", return_hidden=True, remat=False)
    np.testing.assert_allclose(_np(hidden), _np(jh), **TOL[dtype])


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-8b", *MOE])
def test_bf16_prefill_logits_and_cache_match_jax(arch):
    """The bf16 prefill's logits, aux loss and every cache entry for the
    configs the test above runs in f32 only.  Their final-norm hidden
    states are held to the f32 oracle instead
    (``test_bf16_hidden_states_no_farther_from_the_f32_oracle_than_jax``).
    """
    jc, tc, jp, tp = _model(arch, "bfloat16", seed=2)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40))
    want, jaux, jcache = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                                     mode="prefill", return_cache=True,
                                     remat=False)
    got, aux, cache = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                                  return_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])
    np.testing.assert_allclose(float(aux), float(jaux), **TOL["bfloat16"])
    assert set(cache) == set(jcache)
    for name in cache:
        assert cache[name].dtype == torch.bfloat16
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL["bfloat16"])


@pytest.mark.parametrize("arch,n_layers", bf16_oracle.ROWS)
def test_bf16_hidden_states_no_farther_from_the_f32_oracle_than_jax(
        arch, n_layers):
    """The bf16 final-norm hidden states of every family are held to
    ``repro``'s prefill in f32 on the same bf16 params and inputs
    (ROADMAP.md Queue 3): the port's max and 99.9th-percentile error
    from it are no larger than ``repro``'s bf16 run's.  The two bf16 runs
    round at different points (XLA-CPU folds adds into norms and lowers
    ``silu`` op by op; the port keeps the library's activations and the
    stack's last residual add in f32), so they are compared through the
    exact result, not with each other.  granite-8b and deepseek-v2 are
    the rows whose hidden states parted from ``repro``'s past 2e-2."""
    (tm, tq), (jm, jq) = bf16_oracle.errors(arch, n_layers, seed=2)
    assert tm <= jm and tq <= jq, (tm, tq, jm, jq)


def _ragged_decode(arch, dtype):
    """Six decode steps with the slots at different positions (a (B,)
    ``pos``): the logits of every step and the final caches agree."""
    jc, tc, jp, tp = _model(arch, dtype, seed=4)
    rng = np.random.default_rng(6)
    B, S = 3, 48
    start = np.array([0, 5, 40])              # gemma3's window is 32
    jcache = jtf.init_cache(jc, B, S)
    tcache = ttf.init_cache(tc, B, S, device="cpu")
    for t in range(6):
        tok = rng.integers(0, tc.vocab_size, (B, 1))
        pos = (start + t).astype(np.int32)
        jl, jcache = jtf.decode_step(jc, jp, jcache, {
            "token": jnp.asarray(tok, jnp.int32), "pos": jnp.asarray(pos)})
        tl, tcache = ttf.decode_step(tc, tp, tcache, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
        assert tl.shape == (B, 1, tc.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    assert set(tcache) == set(jcache)
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL[dtype])


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b", "qwen2.5-14b",
                                  "granite-8b", *MOE])
def test_decode_steps_match_jax_with_ragged_slots(arch):
    _ragged_decode(arch, "float32")


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b", *MOE])
def test_bf16_decode_steps_match_jax_with_ragged_slots(arch):
    _ragged_decode(arch, "bfloat16")


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_teacher_forcing(arch):
    """tests/test_models_smoke.py's moe rows: step-by-step decode logits
    equal the full forward's at the same positions, at capacity 64
    (nothing dropped), with that test's tolerance; and both equal JAX's
    full forward."""
    jc, tc = _cfg(arch)
    jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=64.0)) for c in (jc, tc))
    jp = jtf.init_params(jc, jax.random.PRNGKey(1))
    tp = ttf.params_from_numpy(tc, _numpy_tree(jp), device="cpu")
    B, S = 2, 12
    tokens = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S))
    full, _ = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)})
    cache = ttf.init_cache(tc, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = ttf.decode_step(tc, tp, cache, {
            "token": torch.from_numpy(tokens[:, t:t + 1]), "pos": t})
        outs.append(_np(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, axis=1), _np(full), atol=2e-3,
                               rtol=2e-3)
    want, _ = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                          mode="prefill", remat=False)
    np.testing.assert_allclose(_np(full), _np(want), **TOL["float32"])


def test_update_cache_clamps_the_position_like_jax():
    """``lax.dynamic_update_slice`` clamps the start into [0, S - 1]; the
    port clamps the same way (torch indexing would raise at pos >= S)."""
    B, S = 4, 5
    cache = np.zeros((B, S, 2, 3), np.float32)
    new = np.arange(B * 6, dtype=np.float32).reshape(B, 1, 2, 3) + 1
    pos = np.array([0, 4, 5, 9], np.int32)
    want = jtf._update_cache(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(pos))
    got = ttf._update_cache(torch.from_numpy(cache.copy()),
                            torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[2:, S - 1] == torch.from_numpy(new[2:, 0])).all()
    scalar = ttf._update_cache(torch.zeros(B, S, 2, 3), torch.from_numpy(new),
                               7)
    np.testing.assert_array_equal(
        scalar.numpy(), np.asarray(jtf._update_cache(
            jnp.zeros((B, S, 2, 3)), jnp.asarray(new), jnp.int32(7))))
