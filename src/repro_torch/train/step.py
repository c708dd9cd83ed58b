"""The train step — the twin of ``repro.train.step``: the forward in
train mode (layer bodies checkpointed), the chunked CE, the backward and
AdamW.

  loss_fn(cfg, params, batch)        -> (total, (ce, aux))
  loss_and_grads(cfg, params, batch) -> ((total, (ce, aux)), grads)
  train_step(cfg, opt_cfg, params, opt_state, batch)
                                     -> (params, opt_state, metrics)

``attn_backend`` ("cuda", the default, or "ref") is the attention's
route: "cuda" runs the flash kernel in the forward (and again in each
checkpointed layer's recompute) and the plain version's gradient in the
backward (``kernels.flash_attention.FlashAttentionFn``).  The params must
require grad (``params.requires_grad_(True)``, as ``launch.train``
does).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.train.loss import chunked_softmax_xent
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

AUX_LOSS_WEIGHT = 0.01


def _head(cfg: ModelConfig, params):
    return (params.embed.T.to(transformer.torch_dtype(cfg))
            if cfg.tie_embeddings else params.lm_head)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            attn_backend: str = "cuda"):
    """The CE over the labels plus ``AUX_LOSS_WEIGHT`` times the MoE
    aux loss; vlm scores its text positions only.  batch: the forward's
    inputs and "labels" (B, S_text) int."""
    hidden, aux = transformer.forward(cfg, params, batch, mode="train",
                                      return_hidden=True,
                                      attn_backend=attn_backend)
    labels = torch.as_tensor(batch["labels"], device=hidden.device)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.n_frontend_tokens:]
    ce = chunked_softmax_xent(hidden, _head(cfg, params), labels)
    return ce + AUX_LOSS_WEIGHT * aux, (ce, aux)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   attn_backend: str = "cuda"):
    """The twin of ``jax.value_and_grad(loss_fn, has_aux=True)``: returns
    ((total, (ce, aux)), {parameter name: gradient}), each gradient in
    its parameter's dtype; a parameter the loss does not use gets zeros
    (JAX's zero cotangent)."""
    named = dict(params.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"loss_and_grads: {len(frozen)} parameters do not "
                         f"require grad (e.g. {frozen[0]}); call "
                         "params.requires_grad_(True) first")
    with torch.enable_grad():
        total, (ce, aux) = loss_fn(cfg, params, batch,
                                   attn_backend=attn_backend)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return (total.detach(), (ce.detach(), aux.detach())), grads


def decay_mask(cfg: ModelConfig, params) -> Dict[str, bool]:
    """{parameter name: decayed}: the JAX package decays a leaf of its
    stacked tree when it has two or more dimensions, so every per-layer
    tensor (norm scales and biases included) is decayed, and an
    unstacked one (``final_norm``, zamba2's shared block's norms) only if
    it is a matrix."""
    named = dict(params.named_parameters())
    return {n: len(e.lead) + named[n].ndim >= 2
            for e in transformer.jax_layout(cfg).values() for n in e.names}


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
               opt_state: OptState, batch, *, attn_backend: str = "cuda"):
    """One step: ``loss_and_grads`` then ``adamw_update`` (in place).
    Returns (params, opt_state, metrics) with the JAX package's keys:
    grad_norm, lr, loss (the CE), aux_loss, total_loss."""
    (total, (ce, aux)), grads = loss_and_grads(cfg, params, batch,
                                               attn_backend=attn_backend)
    params, opt_state, metrics = adamw_update(
        params, grads, opt_state, opt_cfg, decay=decay_mask(cfg, params))
    metrics.update({"loss": ce, "aux_loss": aux, "total_loss": total})
    return params, opt_state, metrics
