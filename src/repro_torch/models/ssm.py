"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] — the twin
of ``repro.models.ssm``.

Chunked prefill: within a chunk the quadratic, attention-like form (three
einsums over the chunk's (L, L, H) decay-weighted scores); across chunks
the linear recurrence of the (B, H, N, P) f32 state, a Python loop where
JAX scans.  Decode: the O(1) state update of one token.  The JAX package
has no Pallas kernel here, so neither has the port: every step is a
PyTorch op (GEMMs through ``torch.matmul``).

The rounding points are those of the JAX package's definition:
the projections in the activation dtype; ``dt`` (softplus) and the scan
in f32, ``y`` cast back to x's dtype; the prefill's causal conv summed in
f32 and cast to the input's dtype before ``silu``, while decode keeps
the conv output in f32; the skip ``y + x * D`` in x's dtype; the gate
norm ``rms_norm(y * silu(z))`` in x's dtype.

  ssd_chunked(x, dt, A, B_, C_, chunk)        -> (y, final state)
  mamba2_block(x, p, cfg, return_state=False) -> out[, SSMCache]
  mamba2_decode(x, p, cfg, cache)             -> (out, SSMCache)
  init_ssm_params(gen, cfg, dtype) / init_ssm_cache(batch, cfg, dtype)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.ops import resolve_device
from repro_torch.models.layers import normal_init, rms_norm


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (..., B, d_conv - 1, conv_dim) in the model dtype
    state: torch.Tensor    # (..., B, H, N, P) f32


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class SSM(nn.Module):
    """w_xz (D, 2 d_inner), w_bc (D, 2 G N), w_dt (D, H), dt_bias (H,)
    f32, conv (d_conv, conv_dim), A_log (H,) f32, D_skip (H,) f32, norm
    (d_inner,), w_out (d_inner, D)."""

    def __init__(self, w_xz, w_bc, w_dt, dt_bias, conv, A_log, D_skip, norm,
                 w_out):
        super().__init__()
        (self.w_xz, self.w_bc, self.w_dt, self.dt_bias, self.conv,
         self.A_log, self.D_skip, self.norm, self.w_out) = map(
            _param, (w_xz, w_bc, w_dt, dt_bias, conv, A_log, D_skip, norm,
                     w_out))


def conv_dim(cfg) -> int:
    s = cfg.ssm
    return s.d_inner + 2 * s.n_groups * s.d_state


def _split_proj(x, p: SSM, cfg):
    d_in = cfg.ssm.d_inner
    xz = x @ p.w_xz
    x_in, z = xz[..., :d_in], xz[..., d_in:]
    bc = x @ p.w_bc
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias.float())
    return x_in, z, bc, dt


def _causal_conv(u, kernel):
    """Depthwise causal conv.  u: (B, S, C); kernel: (W, C).  Summed in
    f32 tap by tap, cast to u's dtype."""
    W, S = kernel.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(W):
        out = out + pad[:, i:i + S].float() * kernel[i].float()
    return out.to(u.dtype)


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """SSD scan.  x (B, S, H, P); dt (B, S, H); A (H,) < 0; B_, C_ (B, S,
    G, N).  One step a chunk carries the (B, H, N, P) state: the chunk's
    quadratic block plus the carried state's contribution.  A ragged S is
    padded with dt = 0 steps (exp(0 A) = 1 and dt B x = 0: exact for the
    rows kept and the state).  Returns y (B, S, H, P) in x's dtype and the
    final state (B, H, N, P) in f32."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    S_orig = S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        S += pad
    nc = S // chunk
    Af = A.float()
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]

    def to_chunks(a, extra):
        return a.float().reshape((Bsz, nc, chunk) + extra)

    xs, dts = to_chunks(x, (H, P)), to_chunks(dt, (H,))
    Bs, Cs = to_chunks(B_, (G, N)), to_chunks(C_, (G, N))
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc = xs[:, c], dts[:, c]             # (B, L, H, P) (B, L, H)
        Bh = Bs[:, c].repeat_interleave(rep, dim=2)      # (B, L, H, N)
        Ch = Cs[:, c].repeat_interleave(rep, dim=2)
        dA = dtc * Af                             # (B, L, H) negative
        cum = torch.cumsum(dA, dim=1)
        seg = cum[:, -1]                          # (B, H)
        # the chunk's quadratic block
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # (B, Li, Lj, H)
        decay = torch.where(causal, torch.exp(diff), 0.0)
        scores = torch.einsum("blhn,bmhn->blmh", Ch, Bh)
        w = scores * decay * dtc[:, None]
        y = torch.einsum("blmh,bmhp->blhp", w, xc)
        # the carried state's contribution
        y = y + torch.einsum("blhn,bhnp->blhp",
                             Ch * torch.exp(cum)[..., None], state)
        # the state update
        to_end = torch.exp(seg[:, None, :] - cum)        # (B, L, H)
        wB = Bh * (to_end * dtc)[..., None]              # (B, L, H, N)
        state = state * torch.exp(seg)[..., None, None] + torch.einsum(
            "blhn,blhp->bhnp", wB, xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y.to(x.dtype), state


def mamba2_block(x, p: SSM, cfg, return_state: bool = False):
    """The Mamba-2 block's prefill.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the ``SSMCache`` decode continues from (the
    last d_conv - 1 conv inputs and the final state)."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P, N, G = s.n_heads, s.head_dim, s.d_state, s.n_groups
    x_in, z, bc, dt = _split_proj(x, p, cfg)
    conv_in = torch.cat([x_in, bc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv))
    x_c = conv_out[..., :s.d_inner]
    bc_c = conv_out[..., s.d_inner:]
    B_ = bc_c[..., :G * N].reshape(B, S, G, N)
    C_ = bc_c[..., G * N:].reshape(B, S, G, N)
    xh = x_c.reshape(B, S, H, P)
    A = -torch.exp(p.A_log.float())
    y, final_state = ssd_chunked(xh, dt, A, B_, C_, s.chunk_size)
    y = y + xh * p.D_skip.to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, s.d_inner)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.w_out
    if return_state:
        return out, SSMCache(conv=conv_in[:, S - (s.d_conv - 1):],
                             state=final_state)
    return out


def mamba2_decode(x, p: SSM, cfg,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token a sequence.  x (B, 1, D).  Returns (out (B, 1, D), the
    new cache), leaving ``cache`` as it was."""
    s = cfg.ssm
    B = x.shape[0]
    H, P, N, G = s.n_heads, s.head_dim, s.d_state, s.n_groups
    x_in, z, bc, dt = _split_proj(x, p, cfg)
    conv_in = torch.cat([x_in, bc], dim=-1)               # (B, 1, cd)
    window = torch.cat([cache.conv, conv_in], dim=1)      # (B, W, cd)
    conv_out = F.silu((window.float() * p.conv.float()).sum(dim=1))[:, None]
    new_conv = window[:, 1:]
    x_c = conv_out[..., :s.d_inner]
    bc_c = conv_out[..., s.d_inner:]
    B_ = bc_c[..., :G * N].reshape(B, G, N)
    C_ = bc_c[..., G * N:].reshape(B, G, N)
    rep = H // G
    Bh = B_.repeat_interleave(rep, dim=1)                 # (B, H, N)
    Ch = C_.repeat_interleave(rep, dim=1)
    xh = x_c.reshape(B, H, P).float()
    A = -torch.exp(p.A_log.float())
    dt1 = dt[:, 0]                                        # (B, H)
    dA = torch.exp(dt1 * A)
    upd = torch.einsum("bhn,bhp->bhnp", Bh * dt1[..., None], xh)
    state = cache.state * dA[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y + xh * p.D_skip.float()[None, :, None]
    y = y.reshape(B, 1, s.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.w_out, SSMCache(conv=new_conv, state=state)



def init_ssm_params(gen: torch.Generator, cfg, dtype) -> SSM:
    """normal(0.02) projections and conv; dt_bias and A_log zero and
    D_skip one (all f32), the norm zero: as the JAX package draws them
    (from a ``torch.Generator``: other numbers)."""
    s, D, dev = cfg.ssm, cfg.d_model, gen.device

    def full(n, v, dt=torch.float32):
        return torch.full((n,), v, dtype=dt, device=dev)

    return SSM(w_xz=normal_init(gen, (D, 2 * s.d_inner), dtype),
               w_bc=normal_init(gen, (D, 2 * s.n_groups * s.d_state),
                                dtype),
               w_dt=normal_init(gen, (D, s.n_heads), dtype),
               dt_bias=full(s.n_heads, 0.0),
               conv=normal_init(gen, (s.d_conv, conv_dim(cfg)), dtype),
               A_log=full(s.n_heads, 0.0), D_skip=full(s.n_heads, 1.0),
               norm=full(s.d_inner, 0.0, dtype),
               w_out=normal_init(gen, (s.d_inner, D), dtype))


def init_ssm_cache(batch: int, cfg, dtype, *, lead=(),
                   device="cuda") -> SSMCache:
    """Zeros on ``device`` ("cuda" raises without a card): conv (*lead,
    batch, d_conv - 1, conv_dim) in ``dtype``, state (*lead, batch, H, N,
    P) in f32 (``lead``: the stacked layer axes of a model's cache)."""
    s = cfg.ssm
    lead = tuple(lead)
    device = resolve_device(device)
    return SSMCache(
        conv=torch.zeros(lead + (batch, s.d_conv - 1, conv_dim(cfg)),
                         dtype=dtype, device=device),
        state=torch.zeros(lead + (batch, s.n_heads, s.d_state, s.head_dim),
                          dtype=torch.float32, device=device))
