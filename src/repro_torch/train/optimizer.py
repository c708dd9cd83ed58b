"""AdamW and its learning-rate schedule — the twin of
``repro.train.optimizer``, with the same math, under ``torch.no_grad()``.

Unlike JAX, which returns new trees, ``adamw_update`` writes the new
parameters and moments into the tensors it is given (saving a copy of
the model and its state each step).  Params, gradients and moments are
{name: tensor} (``nn.Module.named_parameters()``'s names, or a module);
a gradient of None (a parameter the loss does not use: whisper's
``final_norm``) counts as zeros, as JAX's zero cotangent does.

Weight decay goes to the leaves the JAX package decays: those of two or
more dimensions in its params tree, where every layer stack has a
leading layer axis.  The port keeps each layer's tensors apart, so the
caller passes that mask (``train.step.decay_mask``, which
``train.step.train_step`` supplies).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"   # bf16 for the >200B MoE configs


class OptState(NamedTuple):
    step: torch.Tensor              # () int32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _named(params) -> Dict[str, torch.Tensor]:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else dict(params))


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype`` beside each parameter."""
    named = _named(params)
    dt = _DTYPES[cfg.state_dtype]
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in named.items()}

    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros(),
                    zeros())


def abstract_opt_state(abstract_params, cfg: AdamWConfig) -> OptState:
    """``init_opt_state`` over ``transformer.abstract_params``' meta
    tree: the moments' shapes and dtypes, no storage (the dry-run's)."""
    named = _named(abstract_params)
    if not all(p.is_meta for p in named.values()):
        raise ValueError("abstract_opt_state takes meta params "
                         "(transformer.abstract_params)")
    return init_opt_state(named, cfg)


def lr_schedule(step, cfg: AdamWConfig):
    """Linear warm-up to ``cfg.lr``, then a cosine to 0 at
    ``total_steps``; f32, 0-d."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors):
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig,
                 decay: Dict[str, bool]):
    """One AdamW step, in place.  Returns (params, the new state,
    {"grad_norm", "lr"}).  ``decay``: {name: decayed}, for every
    parameter."""
    with torch.no_grad():
        named = _named(params)
        grads = {n: torch.zeros_like(p) if grads.get(n) is None
                 else grads[n] for n, p in named.items()}
        step = state.step + 1
        lr = lr_schedule(step, cfg)
        gnorm = global_norm(grads.values())
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1c = 1.0 - cfg.b1 ** step.float()
        b2c = 1.0 - cfg.b2 ** step.float()
        for n, p in named.items():
            adamw_leaf(p, grads[n], state.m[n], state.v[n], scale, lr,
                       b1c, b2c, cfg, decay[n])
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}


def adamw_leaf(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig,
               decay: bool) -> None:
    """AdamW on one tensor (or one block of it), in place: ``scale`` the
    clip factor, ``lr`` and the bias corrections ``b1c`` and ``b2c`` 0-d
    tensors on its device."""
    mdt = torch.float32 if m.dtype == torch.float32 else torch.bfloat16
    # bf16 state -> bf16 math, with the constants rounded to bf16 first,
    # as JAX's weakly typed Python scalars are

    def c(x):
        return torch.tensor(x, dtype=mdt)

    g = g.to(mdt) * scale.to(mdt)
    m_new = (c(cfg.b1) * m.to(mdt) + c(1 - cfg.b1) * g).to(mdt)
    v_new = (c(cfg.b2) * v.to(mdt)
             + c(1 - cfg.b2) * torch.square(g)).to(mdt)
    mhat = m_new / b1c.to(mdt)
    vhat = v_new.float() / b2c
    delta = mhat.float() / (torch.sqrt(vhat) + cfg.eps)
    if decay:       # decoupled weight decay on JAX's matrices
        delta = delta + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
    m.copy_(m_new)
    v.copy_(v_new)
