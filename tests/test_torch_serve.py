"""Serving in the port (``repro_torch.serve``), mirroring
``tests/test_serve.py``: the engine's greedy decode equals teacher-forced
argmax, ragged slots, ``prefill_step`` equals ``forward``; and the
port's engine picks the same tokens as JAX's ``ServeEngine`` on the
same f32 params.  Params are the JAX package's, carried over by
``params_from_numpy``."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import forward, init_cache, init_params  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.step import prefill_step  # noqa: E402

LOGIT_ATOL = 1e-4        # the f32 logit tolerance of the parity tests


@pytest.fixture(scope="module")
def small_lm():
    jcfg = dataclasses.replace(jget("smollm-360m").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, params, jcfg, jparams


def _logits(cfg, params, toks):
    out, _ = forward(cfg, params, {"tokens": torch.tensor([toks])})
    return out[0].numpy()


def greedy_reference(cfg, params, prompt, n_new):
    """Teacher-forced greedy continuation via a full forward each step."""
    toks = list(map(int, prompt))
    out = []
    for _ in range(n_new):
        nxt = int(_logits(cfg, params, toks)[-1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def test_engine_matches_teacher_forcing(small_lm):
    cfg, params, _, _ = small_lm
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    want = greedy_reference(cfg, params, prompt, 6)
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=32, device="cpu")
    r = Request(uid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(r)
    eng.run()
    assert r.done
    assert r.out_tokens == want, (r.out_tokens, want)


def test_engine_ragged_batch(small_lm):
    """Several requests with different prompt lengths, decoded together:
    each matches its solo teacher-forced continuation."""
    cfg, params, _, _ = small_lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 7, 5)]
    wants = [greedy_reference(cfg, params, p, 4) for p in prompts]
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=32, device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r, want in zip(reqs, wants):
        assert r.done
        assert r.out_tokens == want, (r.uid, r.out_tokens, want)
    assert eng.n_decode_steps == sum(len(p) - 1 for p in prompts) + 4 * 2


def test_prefill_step_logits_match_forward(small_lm):
    cfg, params, _, _ = small_lm
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    for backend in ("cuda", "ref"):
        kops.reset_launch_counts()
        logits, cache = prefill_step(cfg, params, {"tokens": tokens},
                                     attn_backend=backend)
        assert kops.launch_counts()["flash_attention"] == 0   # CPU: plain
        full, _ = forward(cfg, params, {"tokens": tokens})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert cache["k"].shape[0] == cfg.n_layers
        assert logits.dtype == torch.float32


def test_engine_picks_the_tokens_of_the_jax_engine(small_lm):
    """The same ragged requests through both engines give the same tokens.
    Greedy argmax could flip on a near tie, so every chosen token must
    beat the runner-up by more than 10x the logit tolerance, and the
    port's teacher-forced logits must agree with JAX's within it."""
    cfg, params, jcfg, jparams = small_lm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 9, 3, 6)]
    jeng = JEngine(jcfg, jparams, batch_slots=3, max_seq=32)
    teng = ServeEngine(cfg, params, batch_slots=3, max_seq=32, device="cpu")
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert teng.n_decode_steps == jeng.n_decode_steps
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out_tokens == jr.out_tokens, (
            tr.uid, tr.out_tokens, jr.out_tokens)
        seq = list(map(int, tr.prompt)) + tr.out_tokens
        got = _logits(cfg, params, seq[:-1])[len(tr.prompt) - 1:]
        want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray([seq[:-1]])},
                           mode="prefill", remat=False)
        want = np.asarray(want)[0, len(tr.prompt) - 1:]
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(got, axis=-1)[:, -2:]
        assert (got.argmax(-1) == tr.out_tokens).all()
        assert (top2[:, 1] - top2[:, 0] > 10 * LOGIT_ATOL).all(), top2


def test_launcher_serves_every_request_on_the_cpu(capsys):
    reqs, stats = tlaunch.run("smollm-360m", n_requests=5, max_new=4,
                              batch_slots=2, device="cpu")
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert stats["tokens"] == 20
    replay = sum(len(r.prompt) - 1 for r in reqs)
    assert replay + 4 * 3 <= stats["decode_steps"] <= replay + 4 * 5
    assert "served 5 requests, 20 tokens" in capsys.readouterr().out


def test_entry_points_raise_on_cuda_without_a_card(small_lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg, params, _, _ = small_lm
    for call in (lambda: init_params(cfg, 0),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: ServeEngine(cfg, params),
                 lambda: tlaunch.run("smollm-360m", n_requests=1),
                 lambda: tlaunch.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="params are on meta"):
        ServeEngine(cfg, copy.deepcopy(params).to("meta"), device="cpu")
