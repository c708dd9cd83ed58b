"""The port's hybrid family (zamba2-7b: Mamba-2 super-blocks, one shared
attention block with a LoRA per super-block, a Mamba-2 tail) against the
JAX package: ``params_from_numpy`` over the two-axis ``mamba_blocks``,
the prefill's logits, hidden states and every cache entry (k, v, mamba,
tail), decode against teacher forcing and at ragged slots, the cache
shapes, and the serving launcher.  Two configs: ``reduced()`` (2 layers,
attn_interval 2: one super-block, no tail) and the same with n_layers 5
(two super-blocks, a tail layer, two LoRAs).  Every parameter is drawn
from a numpy seed at a non-trivial value (``helpers/torch_parity.py``):
the LoRA b's, A_log, dt_bias and the norms are zero in the JAX init."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
from torch_parity import (TOL, assert_no_farther_from_oracle,  # noqa: E402
                          assert_tree_close, configs, f32_oracle,
                          random_params, to_np, tree_leaves)

ARCH = "zamba2-7b"
LAYERS = [2, 5]        # reduced(): no tail; 5: two super-blocks + a tail


def _model(n_layers, dtype="float32", seed=0):
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype, n_layers=n_layers)
    jp, tree = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                             seed)
    return jc, tc, jp, tree, ttf.params_from_numpy(tc, tree, device="cpu")


def test_layouts():
    for n, want in ((2, (1, 2, 0)), (5, (2, 2, 1))):
        _, tc = configs(jconfigs, tconfigs, ARCH, n_layers=n)
        n_super, inner = ttf._hybrid_layout(tc)
        assert (n_super, inner, tc.n_layers - n_super * inner) == want
    full = tconfigs.get_config(ARCH)
    assert ttf._hybrid_layout(full) == (13, 6)     # 81 = 13 x 6 + 3 tail
    assert full.resolved_head_dim == 112


@pytest.mark.parametrize("n_layers", LAYERS)
def test_params_from_numpy_unstacks_both_axes(n_layers):
    """``mamba_blocks[i][j]`` is the JAX leaf's [i, j], ``lora[i]`` its
    [i], ``shared_attn`` the one block: every leaf bit for bit, none left
    over, every one drawn non-zero; a tree of another depth is refused."""
    jc, tc, jp, tree, tp = _model(n_layers, "bfloat16")
    n_super, inner = ttf._hybrid_layout(tc)
    assert len(tp.mamba_blocks) == n_super
    assert all(len(s) == inner for s in tp.mamba_blocks)
    assert len(tp.lora) == n_super
    assert len(tp.tail_blocks) == n_layers - n_super * inner
    for name, t in tp.named_parameters():
        parts = name.split(".")
        leaf = tree[parts[0]]
        if parts[0] == "mamba_blocks":
            idx, keys = (int(parts[1]), int(parts[2])), parts[3:]
        elif parts[0] in ("tail_blocks", "lora"):
            idx, keys = int(parts[1]), parts[2:]
        else:
            idx, keys = (), parts[1:]
        for k in keys:
            leaf = leaf[k]
        want = np.asarray(leaf)[idx]
        np.testing.assert_array_equal(to_np(t), to_np(want), err_msg=name)
        assert str(t.dtype).split(".")[-1] == str(want.dtype), name
        assert float(t.abs().min()) > 0.0, name
    n = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tp.parameters()) == n
    other = 7 if n_layers == 5 else 4
    _, tc2 = configs(jconfigs, tconfigs, ARCH, "bfloat16", n_layers=other)
    with pytest.raises(ValueError, match="layers"):
        ttf.params_from_numpy(tc2, tree, device="cpu")


@pytest.mark.parametrize("n_layers", LAYERS)
def test_init_params_draws_the_jax_shapes_from_a_seed(n_layers):
    jc, tc = configs(jconfigs, tconfigs, ARCH, "bfloat16", n_layers=n_layers)
    shapes = jax.eval_shape(lambda: jtf.init_params(jc,
                                                    jax.random.PRNGKey(0)))
    a = ttf.init_params(tc, 1, device="cpu")
    b = ttf.init_params(tc, 1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in a.parameters()) == n
    assert tuple(a.lora[0].a_q.shape) == shapes["lora"]["a_q"].shape[1:]
    assert tuple(a.mamba_blocks[0][1].ssm.w_xz.shape) == shapes[
        "mamba_blocks"]["ssm"]["w_xz"].shape[2:]
    assert a.mamba_blocks[0][0].ssm.A_log.dtype == torch.float32
    assert float(a.lora[0].b_q.abs().max()) == 0.0     # JAX's zeros
    assert float(a.mamba_blocks[0][0].ssm.D_skip.min()) == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_forward_and_cache_match_jax(n_layers, dtype):
    """Logits and every cache entry (k, v per super-block; the mamba and
    tail SSM caches) against ``repro.forward``, and in f32 the final-norm
    hidden states (bf16: test_torch_transformer.py's oracle test).  bf16 at 5 layers holds its
    logits and cache entries to the f32 oracle instead (their structure,
    shapes and dtypes still to ``repro``'s): there ``repro``'s own bf16
    logits are up to 0.027 and its k cache 0.024 from the exact result,
    past the 2e-2 that the port's are held to against them at two
    layers, and the port's are nearer it (ROADMAP.md Queue 3).  No flash
    launch here (the wrapper's plain version on the CPU)."""
    jc, tc, jp, _, tp = _model(n_layers, dtype, seed=2)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40))
    batch = {"tokens": jnp.asarray(tokens)}
    want, jaux, jcache = jtf.forward(jc, jp, batch, mode="prefill",
                                     return_cache=True, remat=False)
    kops.reset_launch_counts()
    got, aux, cache = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                                  return_cache=True)
    assert kops.launch_counts()["flash_attention"] == 0
    assert float(aux) == 0.0 and got.dtype == torch.float32
    if dtype == "bfloat16" and n_layers == 5:
        oracle, _, ocache = f32_oracle(jtf, jc, jp, batch, return_cache=True)
        assert_no_farther_from_oracle(got, want, oracle, "logits")
        got_c, want_c, oracle_c = (dict(tree_leaves(c, "cache")) for c in (
            cache, jcache, ocache))
        assert set(got_c) == set(want_c)
        for name, c in got_c.items():
            assert tuple(c.shape) == tuple(want_c[name].shape), name
            assert str(c.dtype).split(".")[-1] == str(want_c[name].dtype)
            assert_no_farther_from_oracle(c, want_c[name], oracle_c[name],
                                          name)
    else:
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])
        assert_tree_close(cache, jcache, TOL[dtype], "cache")
    if dtype == "float32":
        hidden, _ = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                                return_hidden=True, attn_backend="ref")
        jh, _ = jtf.forward(jc, jp, batch, mode="prefill",
                            return_hidden=True, remat=False)
        np.testing.assert_allclose(to_np(hidden), to_np(jh), **TOL[dtype])


@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_matches_teacher_forcing(n_layers):
    """tests/test_models_smoke.py's zamba2 row: step-by-step decode
    logits equal the full forward's (that test's tolerance), which equal
    JAX's."""
    jc, tc, jp, _, tp = _model(n_layers, seed=1)
    B, S = 2, 12
    tokens = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S))
    full, _ = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)})
    cache = ttf.init_cache(tc, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = ttf.decode_step(tc, tp, cache, {
            "token": torch.from_numpy(tokens[:, t:t + 1]), "pos": t})
        outs.append(to_np(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, axis=1), to_np(full),
                               atol=2e-3, rtol=2e-3)
    want, _ = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                          mode="prefill", remat=False)
    np.testing.assert_allclose(to_np(full), to_np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_steps_match_jax_with_ragged_slots(n_layers, dtype):
    """Six decode steps with the slots at different positions (a (B,)
    ``pos``) from zero caches: logits every step, and every cache entry,
    written in place, against JAX's."""
    jc, tc, jp, _, tp = _model(n_layers, dtype, seed=4)
    rng = np.random.default_rng(6)
    B, S = 3, 48
    start = np.array([0, 5, 40])
    jcache = jtf.init_cache(jc, B, S)
    tcache = ttf.init_cache(tc, B, S, device="cpu")
    k = tcache["k"]
    for t in range(6):
        tok = rng.integers(0, tc.vocab_size, (B, 1))
        pos = (start + t).astype(np.int32)
        jl, jcache = jtf.decode_step(jc, jp, jcache, {
            "token": jnp.asarray(tok, jnp.int32), "pos": jnp.asarray(pos)})
        tl, tcache = ttf.decode_step(tc, tp, tcache, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL[dtype])
    assert tcache["k"] is k
    assert_tree_close(tcache, jcache, TOL[dtype], "cache")


@pytest.mark.parametrize("n_layers", LAYERS)
def test_cache_shapes_match_jax(n_layers):
    jc, tc = configs(jconfigs, tconfigs, ARCH, "bfloat16", n_layers=n_layers)
    assert_tree_close(ttf.init_cache(tc, 3, 16, device="cpu"),
                      jtf.init_cache(jc, 3, 16), TOL["bfloat16"], "cache")


def test_lora_reaches_q_k_and_v():
    """Each super-block's LoRA moves its own attention: zeroing the
    second super-block's b_v changes the logits, and only from that
    block's attention on."""
    _, tc, _, _, tp = _model(5, seed=3)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (1, 10)))
    base, _, cache = ttf.forward(tc, tp, {"tokens": tokens},
                                 return_cache=True)
    tp.lora[1].b_v.zero_()
    moved, _, cache2 = ttf.forward(tc, tp, {"tokens": tokens},
                                   return_cache=True)
    assert not torch.allclose(base, moved)
    assert torch.equal(cache["v"][0], cache2["v"][0])
    assert not torch.equal(cache["v"][1], cache2["v"][1])


def test_launch_serve_runs_on_the_cpu():
    """``launch.serve.run`` serves the reduced hybrid through the engine;
    decode launches no flash kernel."""
    kops.reset_launch_counts()
    reqs, stats = launch_serve.run(ARCH, n_requests=3, max_new=4,
                                   batch_slots=2, max_seq=32, device="cpu")
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert stats["tokens"] == 12
    assert kops.launch_counts()["flash_attention"] == 0
