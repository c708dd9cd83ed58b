"""Transformer building blocks — twins of ``repro.models.layers``.

Plain PyTorch, in the JAX package's layouts and its rounding points:
statistics and rotations in f32, results cast back to the input's dtype,
weights stored as (d_in, d_out) so a projection is ``x @ w``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class MetaDraws:
    """Stands in for the ``torch.Generator`` that the ``init_*`` functions
    draw from, on the meta device, where no generator exists: there
    ``normal_init`` gives an empty tensor of the shape it would draw, so
    ``transformer.abstract_params`` builds ``init_params``' tree through
    the same code and allocates nothing."""
    device = torch.device("meta")


def normal_init(gen, shape, dtype):
    """normal(0.02), as ``jax.nn.initializers.normal(0.02)``, drawn in f32
    from ``gen`` on its device and cast to ``dtype``; on the meta device
    (``MetaDraws``) an empty tensor of that shape and dtype."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(
        dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """(x - mean) * rsqrt(var + eps) * scale + bias, in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def swiglu_mlp(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """out(gelu(x @ w_in + b_in)) + b_out, with the tanh gelu
    (``jax.nn.gelu``'s default; ``F.gelu``'s is erf)."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def rope(x, positions, theta):
    """Rotary embedding.  x: (..., S, H, hd); positions: (S,) or (B, S).
    ``theta`` is a Python number, taken as f32 as the JAX package
    carries it (and never copied to the device as a tensor: a host to
    device copy per call would stall every decode step)."""
    return apply_rope(x, *rope_angles(positions, theta, x.shape[-1]))


def rope_angles(positions, theta, hd: int):
    """(cos, sin) of ``rope``'s angles in f32, (..., S, 1, hd // 2): one
    table serves every tensor and layer rotated at these positions."""
    half = hd // 2
    freqs = 1.0 / (float(theta) ** (torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * freqs        # (..., S, half)
    angles = angles[..., None, :]                        # (..., S, 1, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """``rope`` with its angles' (cos, sin) from ``rope_angles``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, dim: int, device=None):
    """(n_pos, dim) f32: [sin | cos] of pos / 10000^(2i / dim), the two
    halves concatenated (not interleaved)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(embedding, tokens, scale: Optional[float] = None):
    """Rows of ``embedding`` for ``tokens``, times ``scale`` rounded to the
    embedding's dtype first (as ``jnp.asarray(scale, out.dtype)``; a 0-d
    CPU tensor, which a CUDA op reads as a scalar)."""
    out = embedding[tokens.long()]
    if scale is not None:
        out = out * torch.tensor(scale, dtype=out.dtype)
    return out
