"""The vlm family (llava-next-34b, ``reduced()``) in the port against the
JAX package: the stub projector's patch embeddings before the text
tokens, the forward, ``prefill_step``'s logits and cache over image and
text positions, the decode step that continues it, and the dtype order
of the projection.  Params are the JAX package's, every leaf drawn from
a numpy seed, carried over by ``params_from_numpy``; the tolerances are
the prefill's (``tests/helpers/torch_parity.py``)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
from torch_parity import (TOL, assert_tree_close, configs,  # noqa: E402
                          random_params, to_np)

ARCH = "llava-next-34b"
B, N_TEXT = 2, 12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the shapes are small, and the tests
    share the CPU with other pytest workers, where PyTorch's OpenMP
    threads, spinning while they wait, slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(dtype="float32", seed=0):
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype)
    jp, npp = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                            seed)
    return jc, tc, jp, ttf.params_from_numpy(tc, npp, device="cpu")


def _inputs(cfg, seed, patch_dtype=np.float32):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(patch_dtype)
    tokens = rng.integers(0, cfg.vocab_size, (B, N_TEXT)).astype(np.int32)
    return patches, tokens


def _batches(patches, tokens, jdt=None, tdt=None):
    jb = {"patches": jnp.asarray(patches, jdt), "tokens": jnp.asarray(tokens)}
    tb = {"patches": torch.from_numpy(np.array(
              jnp.asarray(jb["patches"], jnp.float32))).to(tdt or
                                                          torch.float32),
          "tokens": torch.from_numpy(tokens)}
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_matches_jax(dtype):
    """Logits over every position, image and text (JAX's ``forward``
    returns them all; the loss slices the text), the aux loss 0."""
    jc, tc, jp, tp = _model(dtype, seed=1)
    patches, tokens = _inputs(jc, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jb, tb = _batches(patches, tokens, jdt, tdt)
    want, jaux = jtf.forward(jc, jp, jb, mode="prefill", remat=False)
    with torch.no_grad():
        got, taux = ttf.forward(tc, tp, tb)
    S = jc.n_frontend_tokens + N_TEXT
    assert tuple(got.shape) == (B, S, tc.vocab_size) == want.shape
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


def test_vlm_prefill_step_and_decode_match_jax():
    """``prefill_step``: the last position's logits and the dense cache
    (L, B, n_img + S, K, hd), each entry against JAX's; then one decode
    step at the next position from each package's own cache."""
    jc, tc, jp, tp = _model(seed=3)
    patches, tokens = _inputs(jc, 4)
    jb, tb = _batches(patches, tokens)
    want, jcache = jstep.prefill_step(jc, jp, jb)
    with torch.no_grad():
        got, tcache = tstep.prefill_step(tc, tp, tb)
    S = jc.n_frontend_tokens + N_TEXT
    assert tuple(got.shape) == (B, 1, tc.vocab_size)
    assert tuple(tcache["k"].shape) == (tc.n_layers, B, S, tc.n_kv_heads,
                                        tc.resolved_head_dim)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL["float32"])
    assert_tree_close(tcache, jcache, TOL["float32"], "cache")
    # decode needs room for one more token: grow both caches by a row
    nxt = np.argmax(to_np(want)[:, 0], axis=-1).astype(np.int32)[:, None]
    jcache = {n: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
              for n, c in jcache.items()}
    tcache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
              for n, c in tcache.items()}
    jl, _ = jtf.decode_step(jc, jp, jcache, {"token": jnp.asarray(nxt),
                                             "pos": jnp.int32(S)})
    with torch.no_grad():
        tl, _ = ttf.decode_step(tc, tp, tcache,
                                {"token": torch.from_numpy(nxt), "pos": S})
    np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL["float32"])


@pytest.mark.parametrize("model_dtype,patch_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_vlm_projects_patches_in_the_promoted_type(model_dtype,
                                                   patch_dtype):
    """JAX's einsum runs in the promoted type of the patches and the
    projector, then casts to the embeddings' dtype: bf16 patches under
    an f32 model project in f32, f32 patches under a bf16 model project
    in f32 and round once."""
    jc, tc, jp, tp = _model(model_dtype, seed=5)
    patches, tokens = _inputs(jc, 6)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[patch_dtype]
    jb, tb = _batches(patches, tokens, jdt, tdt)
    want, _ = jtf._embed_inputs(jc, jp, jb)
    got, pos = ttf._embed_inputs(tc, tp, tb)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == model_dtype
    assert pos.tolist() == list(range(jc.n_frontend_tokens + N_TEXT))
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[model_dtype])
    # the text rows are the embeddings, bit for bit
    np.testing.assert_array_equal(to_np(got[:, jc.n_frontend_tokens:]),
                                  to_np(want[:, jc.n_frontend_tokens:]))


def test_both_engines_refuse_vlm():
    """``ServeEngine`` drives text decoders, in either package."""
    from repro.serve.engine import ServeEngine as JaxEngine
    jc, tc, jp, tp = _model()
    with pytest.raises(ValueError, match="text decoders"):
        ServeEngine(tc, tp, device="cpu")
    with pytest.raises(AssertionError, match="text decoders"):
        JaxEngine(jc, jp)
