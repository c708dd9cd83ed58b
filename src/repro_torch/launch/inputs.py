"""Meta-tensor stand-ins for every model input — the twin of
``repro.launch.inputs`` (JAX's ``ShapeDtypeStruct``s): nothing is
allocated.

``input_specs(cfg, shape)`` returns the abstract batch for the step
kind; ``step_arguments(cfg, shape, mesh, opt_cfg)`` returns (step_fn,
abstract args, their specs, the outputs' specs, the donated argument
indices), as JAX's returns them for ``jit().lower()``.  The step runs
the attention on the flash kernel's path (``attn_backend="cuda"``): on
a meta tensor the kernel's wrapper is one shape-only op with the
kernel's FLOPs (``kernels.flash_attention``), as JAX's step runs its
chunked ``flash_attention_jnp`` and never holds the (S, S) scores.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.serve.step import prefill_step, serve_step
from repro_torch.sharding.specs import (batch_specs, cache_specs,
                                        logical_axes, param_specs,
                                        shard_if_divisible)
from repro_torch.train.optimizer import (AdamWConfig, OptState,
                                         abstract_opt_state)
from repro_torch.train.step import train_step

ATTN_BACKEND = "cuda"
_METRIC_KEYS = ("grad_norm", "lr", "loss", "aux_loss", "total_loss")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(*shape):
    return _meta(shape, torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """The abstract batch dict for this (arch, shape): int32 tokens,
    bf16 frames and patches, as JAX's."""
    B, S = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16
    if shape.kind == "decode":
        return {"token": _tok(B, 1), "pos": _meta((), torch.int32)}
    if cfg.family == "audio":
        d = {"frames": _meta((B, cfg.n_frontend_tokens, cfg.frontend_dim),
                             bf16),
             "tokens": _tok(B, S)}
        if shape.kind == "train":
            d["labels"] = _tok(B, S)
        return d
    if cfg.family == "vlm":
        n_img = cfg.n_frontend_tokens
        d = {"patches": _meta((B, n_img, cfg.frontend_dim), bf16),
             "tokens": _tok(B, S - n_img)}
        if shape.kind == "train":
            d["labels"] = _tok(B, S - n_img)
        return d
    d = {"tokens": _tok(B, S)}
    if shape.kind == "train":
        d["labels"] = _tok(B, S)
    return d


def _logits_spec(mesh, shape: InputShape, cfg: ModelConfig):
    ax = logical_axes(mesh)
    return (shard_if_divisible(mesh, shape.global_batch, ax["dp"]), None,
            shard_if_divisible(mesh, cfg.vocab_size, ax["tp"]))


def step_arguments(cfg: ModelConfig, shape: InputShape, mesh,
                   opt_cfg: AdamWConfig | None = None
                   ) -> Tuple[Any, tuple, tuple, tuple, tuple]:
    """(step_fn, abstract args, their specs, the outputs' specs, the
    donated argument indices).  The step is ``train_step`` (params
    requiring grad; AdamW state in bf16 past 1e11 params, as JAX's),
    ``prefill_step`` or ``serve_step``."""
    opt_cfg = opt_cfg or AdamWConfig(
        state_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32")
    params = transformer.abstract_params(cfg)
    pspec = param_specs(cfg, params, mesh)
    batch = input_specs(cfg, shape)
    bspec = batch_specs(cfg, batch, mesh, shape)

    if shape.kind == "train":
        params.requires_grad_(True)
        opt = abstract_opt_state(params, opt_cfg)
        ospec = OptState(step=(), m=pspec, v=pspec)
        fn = functools.partial(train_step, cfg, opt_cfg,
                               attn_backend=ATTN_BACKEND)
        metrics = {k: () for k in _METRIC_KEYS}
        return (fn, (params, opt, batch), (pspec, ospec, bspec),
                (pspec, ospec, metrics), (0, 1))

    enc_len = cfg.n_frontend_tokens if cfg.family == "audio" else None
    cache = transformer.abstract_cache(cfg, shape.global_batch,
                                       shape.seq_len, enc_len)
    cspec = cache_specs(cfg, cache, mesh, shape)
    lspec = _logits_spec(mesh, shape, cfg)
    if shape.kind == "prefill":
        fn = functools.partial(prefill_step, cfg, attn_backend=ATTN_BACKEND)
        return fn, (params, batch), (pspec, bspec), (lspec, cspec), ()
    fn = functools.partial(serve_step, cfg, attn_backend=ATTN_BACKEND)
    return (fn, (params, cache, batch), (pspec, cspec, bspec),
            (lspec, cspec), (1,))
