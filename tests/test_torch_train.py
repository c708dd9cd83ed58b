"""The port's training (``repro_torch.train``, ``launch.train``, the
forward in train mode and ``FlashAttentionFn``) against the JAX
package's: the loss and every gradient for each architecture, AdamW and
its schedule on identical gradients, the weight-decay mask, the data
stream bit for bit, checkpoints across the two packages, and the
launcher.  Params are the JAX package's, every leaf drawn from a numpy
seed (``tests/helpers/torch_parity.py``), carried over by
``params_from_numpy``; configs are ``reduced()`` in f32.

Tolerances, f32: the loss and the aux loss atol 1e-5, rtol 1e-4; each
gradient element atol 1e-5, rtol 1e-3 (JAX differentiates its chunked
``flash_attention_jnp``, the port the plain attention, each with its own
summation order).  Measured over all ten architectures: the loss within
9.5e-7 (smollm-360m, llava-next-34b), the aux loss exactly, every
gradient element within 1.5e-7 (granite-8b, mamba2-1.3b), at most 0.9%
of its tolerance (mamba2-1.3b's embedding)."""
import functools
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
from torch_parity import configs, random_params, to_np  # noqa: E402

LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the shapes are small, and the tests
    share the CPU with other pytest workers, where PyTorch's OpenMP
    threads, spinning while they wait, slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    """numpy inputs and labels of ``tests/test_models_smoke.py``'s shapes:
    vlm's S covers image and text (labels over the text), audio's frames
    are the reduced config's 16."""
    rng = np.random.default_rng(seed)
    n_text = S - cfg.n_frontend_tokens if cfg.family == "vlm" else S
    d = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_text)).astype(
        np.int32)}
    d["labels"] = rng.integers(0, cfg.vocab_size, (B, n_text)).astype(
        np.int32)
    if cfg.family == "audio":
        d["frames"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        d["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return d


def _setup(arch, seed=0, **changes):
    jc, tc = configs(jconfigs, tconfigs, arch, **changes)
    jp, npp = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                            seed)
    tp = ttf.params_from_numpy(tc, npp, device="cpu")
    return jc, tc, jp, tp, _batch(jc, seed)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), v


def _assert_trees_close(got, want, tol, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), what
    for k in want:
        assert got[k].shape == tuple(want[k].shape), f"{what} {k}"
        np.testing.assert_allclose(got[k], to_np(want[k]),
                                   err_msg=f"{what} {k}", **tol)


# ----------------------------------------------------------------------
# the loss and its gradients, every architecture
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_and_train_step_match_jax(arch):
    """``loss_and_grads`` (attention through ``FlashAttentionFn``: the
    plain version's forward and chunked backward on the CPU) against
    ``jax.value_and_grad(loss_fn, has_aux=True)``: total, CE and aux,
    and every gradient leaf restacked by ``params_to_numpy``.  Shared
    parameters (zamba2's shared attention, 1 block called per
    super-block) accumulate into one gradient; whisper's unused
    ``final_norm`` gets JAX's zeros.  Then ``train_step`` from the same
    params (the twin of ``test_models_smoke.py::test_one_train_step``):
    JAX's metric keys, its grad_norm and lr on these gradients, and the
    params moved (the update itself is held on identical gradients below:
    step 1's is sign(g) lr, which a gradient near 0 can flip)."""
    jc, tc, jp, tp, batch = _setup(arch, seed=3)
    (jt, (jce, jaux)), jg = jax.jit(jax.value_and_grad(
        functools.partial(jstep.loss_fn, jc), has_aux=True))(
            jp, _jbatch(batch))
    tp.requires_grad_(True)
    (tt, (tce, taux)), tg = tstep.loss_and_grads(tc, tp, _tbatch(batch))
    for got, want in ((tt, jt), (tce, jce), (taux, jaux)):
        np.testing.assert_allclose(to_np(got), to_np(want), **LOSS_TOL)
    assert float(tce) > 0
    _assert_trees_close(ttf.params_to_numpy(tc, tg), jg, GRAD_TOL, arch)
    assert set(tg) == {n for n, _ in tp.named_parameters()}
    assert all(g.dtype == p.dtype for (n, p), g in
               zip(tp.named_parameters(), tg.values()))
    if arch == "whisper-base":
        assert float(tg["final_norm"].abs().max()) == 0.0
    assert any(float(g.abs().max()) > 0 for g in tg.values())

    opt_cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    tp2, ts, tm = tstep.train_step(tc, opt_cfg, tp, topt.init_opt_state(
        tp, opt_cfg), _tbatch(batch))
    want = {"loss": jce, "aux_loss": jaux, "total_loss": jt,
            "grad_norm": jopt.global_norm(jg),
            "lr": jopt.lr_schedule(jnp.int32(1), jopt.AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=10))}
    assert set(tm) == set(want)
    for key in want:
        np.testing.assert_allclose(float(tm[key]), float(want[key]),
                                   **LOSS_TOL, err_msg=key)
    assert tp2 is tp and int(ts.step) == 1
    with torch.no_grad():
        assert sum(float((p - before[n]).abs().sum())
                   for n, p in tp.named_parameters()) > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_train_mode_equals_prefill_and_remat_equals_no_remat(arch):
    """Checkpointing changes no number: the train-mode forward equals the
    prefill, and the gradients with ``remat`` equal those without, bit
    for bit; "ref" gives the same loss."""
    _, tc, _, tp, batch = _setup(arch, seed=4)
    tb = _tbatch(batch)
    with torch.no_grad():
        pre, _ = ttf.forward(tc, tp, tb, mode="prefill")
        tr, _ = ttf.forward(tc, tp, tb, mode="train")
    assert torch.equal(pre, tr)
    tp.requires_grad_(True)
    outs = {}
    for remat in (True, False):
        with torch.enable_grad():
            h, aux = ttf.forward(tc, tp, tb, mode="train", remat=remat,
                                 return_hidden=True)
            loss = h.square().mean() + aux
            outs[remat] = torch.autograd.grad(loss, list(tp.parameters()),
                                              allow_unused=True)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(outs[True], outs[False]))
    assert sum(g is not None for g in outs[True]) > 4
    (t_cuda, _), _ = tstep.loss_and_grads(tc, tp, tb)
    (t_ref, _), _ = tstep.loss_and_grads(tc, tp, tb, attn_backend="ref")
    np.testing.assert_allclose(float(t_cuda), float(t_ref), rtol=1e-6)
    with pytest.raises(ValueError, match="no cache"):
        ttf.forward(tc, tp, tb, mode="train", return_cache=True)


def test_loss_and_grads_asks_for_grad_mode_on_the_params():
    _, tc, _, tp, batch = _setup("smollm-360m")
    with pytest.raises(ValueError, match="requires_grad_"):
        tstep.loss_and_grads(tc, tp, _tbatch(batch))


@pytest.mark.parametrize("S_", [5, 16, 21])
def test_chunked_xent_matches_jax_on_ragged_spans(S_):
    """Chunks of 8 over 5, 16 and 21 positions (the pad masked), with a
    mask of the caller's, and its gradients."""
    rng = np.random.default_rng(S_)
    h = rng.standard_normal((2, S_, 12)).astype(np.float32)
    head = (0.3 * rng.standard_normal((12, 40))).astype(np.float32)
    lab = rng.integers(0, 40, (2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) < 0.8).astype(np.float32)
    jf = lambda h_, w: jloss.chunked_softmax_xent(h_, w, jnp.asarray(lab),
                                                  chunk=8,
                                                  mask=jnp.asarray(mask))
    jv, (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    tv = tloss.chunked_softmax_xent(th, tw, torch.from_numpy(lab), chunk=8,
                                    mask=torch.from_numpy(mask))
    tgh, tgw = torch.autograd.grad(tv, (th, tw))
    np.testing.assert_allclose(float(tv.detach()), float(jv),
                               **LOSS_TOL)
    np.testing.assert_allclose(to_np(tgh), to_np(jgh), **GRAD_TOL)
    np.testing.assert_allclose(to_np(tgw), to_np(jgw), **GRAD_TOL)


# ----------------------------------------------------------------------
# FlashAttentionFn on the CPU
# ----------------------------------------------------------------------

# B, Sq, Skv, H, K, hd, vd, q_offset, causal, window
FN_CASES = [(2, 40, 40, 4, 2, 16, 16, 0, True, None),
            (1, 33, 33, 6, 6, 8, 8, 0, True, 9),
            (2, 24, 40, 4, 1, 16, 16, 0, False, None),
            (2, 20, 40, 4, 2, 16, 16, 20, True, None),
            (1, 40, 40, 4, 4, 24, 16, 0, True, None)]


@pytest.mark.parametrize("B_,Sq,Skv,H,K,hd,vd,q_offset,causal,window",
                         FN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fn_gradients_equal_the_plain_versions(
        monkeypatch, B_, Sq, Skv, H, K, hd, vd, q_offset, causal, window,
        dtype):
    """Under autograd the wrapper goes through ``FlashAttentionFn``; its
    forward is the plain version's output bit for bit on the CPU and its
    chunked backward (chunks of 16 rows here) gives the plain version's
    gradients: GQA, a window, Sq != Skv (cross), a q offset, vd != hd."""
    monkeypatch.setattr(tflash, "BACKWARD_ROWS", 16)
    g = torch.Generator().manual_seed(Sq + hd)
    q = torch.randn((B_, Sq, H, hd), generator=g).to(dtype)
    k = torch.randn((B_, Skv, K, hd), generator=g).to(dtype)
    v = torch.randn((B_, Skv, K, vd), generator=g).to(dtype)
    go = torch.randn((B_, Sq, H, vd), generator=g).to(dtype)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    grads = []
    for fn in (tflash.flash_attention_gqa, tref.gqa_attention_ref):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, **kw)
        grads.append((out, torch.autograd.grad(out, ins, go)))
    (got, g_got), (want, g_want) = grads
    assert type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(got, want)
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for a, b in zip(g_got, g_want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(to_np(a), to_np(b), **tol)


def test_flash_fn_carries_the_pallas_signature():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((3, 20, 8), generator=g).requires_grad_()
               for _ in range(3))
    out = tflash.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention_ref(q, k, v, causal=True)
    gw = torch.autograd.grad(want.sum(), (q, k, v))
    gg = torch.autograd.grad(out.sum(), (q, k, v))
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------------
# AdamW, its schedule and the decay mask
# ----------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=40)
    for step in range(0, 45):
        want = jopt.lr_schedule(jnp.int32(step), jopt.AdamWConfig(**cfg))
        got = topt.lr_schedule(torch.tensor(step, dtype=torch.int32),
                               topt.AdamWConfig(**cfg))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_on_identical_grads(state_dtype):
    """Three steps from the same params on the same gradients (one
    clipped, one a None gradient the port takes as zeros): params,
    moments, grad_norm and lr within 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 8), "b": (8,), "c": (3, 4, 5), "d": (6,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    cfgs = [m.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          state_dtype=state_dtype, grad_clip=1.0)
            for m in (jopt, topt)]
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ts = jopt.init_opt_state(jp, cfgs[0]), topt.init_opt_state(tp,
                                                                  cfgs[1])
    for it, scale in enumerate((0.01, 0.5, 0.02)):
        grads = {n: (scale * rng.standard_normal(s)).astype(np.float32)
                 for n, s in shapes.items()}
        grads["d"] = np.zeros(shapes["d"], np.float32)
        jp, js, jm = jopt.adamw_update(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, js, cfgs[0])
        tg = {n: torch.from_numpy(g) for n, g in grads.items()}
        tg["d"] = None
        tp, ts, tm = topt.adamw_update(
            tp, tg, ts, cfgs[1], decay={n: a.ndim >= 2
                                        for n, a in params.items()})
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        for name in shapes:
            for got, want in ((tp[name], jp[name]), (ts.m[name], js.m[name]),
                              (ts.v[name], js.v[name])):
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                np.testing.assert_allclose(to_np(got), to_np(want),
                                           atol=1e-6, rtol=0,
                                           err_msg=f"step {it} {name}")
        assert int(ts.step) == int(js.step) == it + 1


def _jax_paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_paths(v, pre + (k,))
        else:
            yield pre + (k,), v


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_decay_mask_is_the_jax_ndim_rule(arch):
    """JAX decays a leaf of its stacked tree when ndim >= 2: every
    per-layer norm scale and bias, never ``final_norm`` or an unstacked
    (D,) leaf.  The port's mask over its per-layer tensors says the same
    for each of them."""
    jc, tc = configs(jconfigs, tconfigs, arch)
    shapes = jtf.abstract_params(jc)
    tp = ttf.init_params(tc, 0, device="cpu")
    mask = tstep.decay_mask(tc, tp)
    layout = ttf.jax_layout(tc)
    assert set(mask) == {n for n, _ in tp.named_parameters()}
    assert set(layout) == {p for p, _ in _jax_paths(shapes)}
    for path, leaf in _jax_paths(shapes):
        assert all(mask[n] == (leaf.ndim >= 2) for n in layout[path].names)
    assert not mask["final_norm"]
    if tc.family in ("dense", "vlm"):
        assert mask["blocks.0.pre_attn_norm"]


def test_adamw_converges_quadratic():
    """The twin of ``tests/test_train.py::test_adamw_converges_quadratic``."""
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                           weight_decay=0.0, grad_clip=100.0)
    params = {"x": torch.ones((4, 4)) * 5.0}
    opt = topt.init_opt_state(params, cfg)
    for _ in range(150):
        x = params["x"].detach().requires_grad_()
        g = torch.autograd.grad(torch.sum(x ** 2), x)[0]
        params, opt, _ = topt.adamw_update(params, {"x": g}, opt, cfg,
                                           decay={"x": True})
    assert float(torch.sum(params["x"] ** 2)) < 0.3


# ----------------------------------------------------------------------
# data and checkpoints
# ----------------------------------------------------------------------

def test_synthetic_and_file_batches_are_jaxs_bitwise(tmp_path):
    corpus = tmp_path / "tokens.npy"
    np.save(corpus, np.random.default_rng(2).integers(0, 300, 5000).astype(
        np.uint16))
    for path in (None, str(corpus)):
        cfgs = [m.DataConfig(vocab_size=300, seq_len=24, batch_size=3,
                             seed=4, corpus_path=path)
                for m in (jdata, tdata)]
        make = (jdata.synthetic_batches, tdata.synthetic_batches) \
            if path is None else (jdata.file_batches, tdata.file_batches)
        want, got = make[0](cfgs[0]), make[1](cfgs[1])
        pipe = tdata.make_pipeline(cfgs[1])
        for _ in range(3):
            w, g, p = next(want), next(got), next(pipe)
            for key in ("tokens", "labels"):
                assert g[key].dtype == w[key].dtype == np.int32
                np.testing.assert_array_equal(g[key], w[key])
                np.testing.assert_array_equal(p[key], w[key])
        pipe.close()


@pytest.mark.parametrize("arch,dtype", [("smollm-360m", "bfloat16"),
                                        ("zamba2-7b", "float32"),
                                        ("whisper-base", "float32")])
def test_checkpoints_restore_across_packages(tmp_path, arch, dtype):
    """The port's file restores through ``repro.train.checkpoint`` and the
    JAX package's through the port's: params and AdamW state bitwise,
    the step and the metadata (bf16 stored as f32; zamba2's empty tail
    stack as zero-length arrays)."""
    jc, tc = configs(jconfigs, tconfigs, arch, dtype=dtype)
    jp0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    _, npp = random_params(jp0, 7)
    jp2, _ = random_params(jp0, 8)
    (m, _), (v, _) = (random_params(jp0, s) for s in (9, 10))
    jo = jopt.OptState(step=jnp.int32(1), m=m, v=jax.tree.map(jnp.abs, v))
    to_cfg = topt.AdamWConfig()
    tp = ttf.params_from_numpy(tc, jax.tree.map(np.asarray, jp2),
                               device="cpu")
    # the JAX package's file, restored by the port
    jpath = tmp_path / "jax.npz"
    jckpt.save_checkpoint(jpath, jp2, jo, step=5, metadata={"arch": arch})
    fresh = ttf.params_from_numpy(tc, npp, device="cpu")
    fresh_opt = topt.init_opt_state(fresh, to_cfg)
    got, got_opt, step = tckpt.restore_checkpoint(jpath, fresh, fresh_opt,
                                                  cfg=tc)
    assert step == 5 and got is fresh and int(got_opt.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(got.parameters(),
                                                 tp.parameters()))
    _assert_trees_close(ttf.params_to_numpy(tc, got_opt.m), jo.m,
                        dict(atol=0, rtol=0), "m")
    # the port's file, restored by the JAX package
    tpath = tmp_path / "torch.npz"
    tckpt.save_checkpoint(tpath, got, got_opt, step=9,
                          metadata={"arch": arch}, cfg=tc)
    rp, ro, rstep = jckpt.restore_checkpoint(tpath, jp0, jo)
    assert rstep == 9
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(jp2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    for a, b in zip(jax.tree.leaves(ro), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    z = np.load(tpath)
    assert set(z.files) == set(np.load(jpath).files)
    assert str(z["__meta__"]) == str(np.load(jpath)["__meta__"])


def test_params_to_numpy_inverts_params_from_numpy():
    for arch in ("zamba2-7b", "deepseek-v2-236b", "llava-next-34b"):
        jc, tc = configs(jconfigs, tconfigs, arch)
        _, npp = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)), 1)
        back = ttf.params_to_numpy(tc, ttf.params_from_numpy(
            tc, npp, device="cpu"))
        _assert_trees_close(back, npp, dict(atol=0, rtol=0), arch)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

@pytest.mark.slow
def test_loss_decreases():
    """The twin of ``tests/test_train.py::test_loss_decreases``."""
    _, losses = tlaunch.run("smollm-360m", steps=60, batch=4, seq=64,
                            reduced=True, lr=3e-3, log_every=20,
                            device="cpu")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.15, (first, last)


def test_launcher_refuses_what_jax_refuses(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tlaunch.run("llava-next-34b", steps=1, device="cpu")
    with pytest.raises(SystemExit):
        tlaunch.run("whisper-base", steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        tlaunch.run("smollm-360m", steps=1, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        tlaunch.main(["--production-mesh", "--device", "cpu"])
    path = tmp_path / "run.npz"
    params, losses = tlaunch.run("smollm-360m", steps=2, batch=2, seq=16,
                                 log_every=1, checkpoint_path=path,
                                 device="cpu")
    out = capsys.readouterr().out
    assert "step     1  loss " in out and "s/step" in out and "gnorm" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
    z = np.load(path)
    assert int(z["__step__"]) == 2 and int(z["opt::.step"]) == 2
