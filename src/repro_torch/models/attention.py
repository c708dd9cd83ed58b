"""GQA and MLA attention for prefill and decode — twins of
``repro.models.attention``.

- ``simple_attention``: unchunked GQA attention in f32, the plain
  version (``kernels.ref.gqa_attention_ref``).
- ``flash_attention``: the counterpart of ``flash_attention_jnp``, with its
  (B, S, H, hd) / (B, S, K, hd) layout (v's head dim may differ: MLA) and
  its ``q_offset``, ``causal``, ``window`` and ``scale``.  ``backend`` names the executor, as the GNN
  executors are named: ``"cuda"`` calls the hand-written kernel's wrapper
  (``kernels.flash_attention.flash_attention_gqa``: the kernel for CUDA
  tensors, the plain version for CPU ones), ``"ref"`` the plain version
  on any device.  It is the caller's choice, never a fallback.
- ``decode_attention``: one new token against a (B, S, K, hd) cache with
  a per-slot ``cache_len``, in plain PyTorch (JAX computes it with
  ``jnp`` outside any kernel).

- MLA (DeepSeek-V2's multi-head latent attention): ``mla_prefill``
  expands the latent kv and runs ``flash_attention`` with q and k at
  nope + rope = 192 columns and v at 128 (the kernels take vd != hd);
  ``mla_decode`` attends in the kv_lora latent space with W_uk absorbed
  into q, in plain PyTorch in f32 (JAX computes it with ``jnp`` outside
  any kernel); ``mla_new_cache_entries`` gives a new token's (c_kv,
  k_rope).

- ``cp_decode_attention``: JAX's sequence-parallel decode attention
  (the long_500k path under ``tuning.on("cp_decode")``) over the
  ``data`` shards of a mesh: on a cache placed by the sharding rules
  (``sharding.placement``), each shard's scores on its own card against
  its own sequence block, only the softmax partials crossing; or on a
  whole cache on the mesh's home, split by views.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.launch.mesh import check_mesh
from repro_torch.kernels import ref
from repro_torch.models.layers import rms_norm, rope
from repro_torch.sharding.placement import Placed, gather_slab, move

BACKENDS = ("cuda", "ref")
_NEG_INF = -1e30

simple_attention = ref.gqa_attention_ref


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, backend: str = "cuda"):
    """q: (B, Sq, H, hd); k: (B, Skv, K, hd) and v: (B, Skv, K, vd) with
    H % K == 0.  Returns (B, Sq, H, vd) in q's dtype."""
    if backend == "cuda":
        return _flash.flash_attention_gqa(q, k, v, q_offset=q_offset,
                                          causal=causal, window=window,
                                          scale=scale)
    if backend == "ref":
        return simple_attention(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, scale=scale)
    raise ValueError(f"unknown attention backend {backend!r}; choose one "
                     f"of {BACKENDS}")


def decode_attention(q, k_cache, v_cache, *, cache_len,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """One-token GQA decode.  q: (B, 1, H, hd); caches (B, S, K, hd).
    ``cache_len``: valid entries per sequence, an int or a (B,) tensor
    (continuous batching: slots at different lengths); the new token
    sits at cache_len - 1."""
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise ValueError(f"decode_attention takes one token, got {Sq}")
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, K, H // K, hd).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    kv_pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).broadcast_to(
        (B,))[:, None]
    msk = kv_pos[None, :] < clen
    if window is not None:
        msk &= (clen - 1 - kv_pos[None, :]) < window
    p = torch.softmax(torch.where(msk[:, None, None, :], s, _NEG_INF),
                      dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cp_decode_attention(q, k_cache, v_cache, *, cache_len, mesh,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``decode_attention`` with the caches' sequence split over the
    mesh's ``data`` shards (S % data == 0), as JAX's ``shard_map`` path
    computes it.  Shard i holds [i S_loc, (i + 1) S_loc) of each cache,
    masks by the global positions i S_loc + arange(S_loc), and computes
    its scores and their max; the global max is the max over the shards;
    each shard then computes p, l and acc in f32, and l and acc are
    summed in shard order.

    q is on the mesh's home (shard (0, 0)).  With ``Placed`` caches
    (``sharding.placement``: their sequence over ``data``) shard i works
    on its card, ``mesh.device(i, 0)``, against its own block (gathered
    over ``model`` there if the rules split the head dim over it); q
    and the cache length go out, the (B, K, G) maxima come home, the
    global max goes back, and each shard's (B, K, G) sums and (B, K, G,
    hd) accumulators come home: the "softmax" messages, never the cache.
    With whole caches on the home, the shards are views of them and
    nothing is copied; the two give the same bits."""
    check_mesh(mesh, q.device)
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise ValueError(f"cp_decode_attention takes one token, got {Sq}")
    S, K = k_cache.shape[1], k_cache.shape[2]
    P = mesh.shape["data"]
    if S % P:
        raise ValueError(f"cp_decode_attention: S={S} does not divide "
                         f"over {P} data shards")
    S_loc = S // P
    placed = isinstance(k_cache, Placed)
    if placed != isinstance(v_cache, Placed):
        raise ValueError("cp_decode_attention: place both caches or none")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, K, H // K, hd).float() * scale
    clen = torch.as_tensor(cache_len, device=q.device).broadcast_to(
        (B,))[:, None]

    def dev(i):
        return mesh.device(i, 0) if placed else q.device

    def there(t, i):            # home -> data shard i's (i, 0)
        return t if not placed or i == 0 else move(mesh, "softmax", t,
                                                   i * mesh.M, 0)

    def home(t, i):             # data shard i's (i, 0) -> home
        return t if not placed or i == 0 else move(mesh, "softmax", t, 0,
                                                   i * mesh.M)

    def block(c, i):
        if placed:
            return gather_slab(c, {"data": i}, i * mesh.M, kind="cache")
        return c[:, i * S_loc:(i + 1) * S_loc]

    scores = []
    for i in range(P):
        kv_pos = i * S_loc + torch.arange(S_loc, device=dev(i))
        cl = there(clen, i)
        s = torch.einsum("bkgd,bskd->bkgs", there(qf, i),
                         block(k_cache, i).float())
        msk = kv_pos[None, :] < cl
        if window is not None:
            msk &= (cl - 1 - kv_pos[None, :]) < window
        scores.append(torch.where(msk[:, None, None, :], s, _NEG_INF))
    m = torch.stack([home(s.amax(dim=-1), i)
                     for i, s in enumerate(scores)]).amax(dim=0)
    l = acc = None
    for i, s in enumerate(scores):
        p = torch.exp(s - there(m, i)[..., None])
        l_i = home(p.sum(dim=-1), i)
        acc_i = home(torch.einsum("bkgs,bskd->bkgd", p,
                                  block(v_cache, i).float()), i)
        l = l_i if l is None else l + l_i
        acc = acc_i if acc is None else acc + acc_i
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-space attention with absorbed decode
# ----------------------------------------------------------------------

def mla_prefill(x, p, cfg, positions, *, backend: str = "cuda"):
    """Multi-head latent attention, prefill.  ``p``: wq_a (D, qr), q_norm
    (qr,), wq_b (qr, H (nope + rope)), wkv_a (D, kvr + rope), kv_norm
    (kvr,), wkv_b (kvr, H (nope + v)), wo (H v, D).  Returns (out, c_kv
    (B, S, kvr), k_rope (B, S, rope)), the caches decode reads.

    v is the ``kv[..., nope:]`` view of the expanded kv, passed to the
    kernel as it is; k is ``cat(k_nope, k_rope)``, with the head-shared
    k_rope broadcast to every head (the kernels read no stride-0 head)."""
    a = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nd, rd, vd = a.nope_head_dim, a.rope_head_dim, a.v_head_dim
    q_lat = rms_norm(x @ p.wq_a, p.q_norm)
    q = (q_lat @ p.wq_b).reshape(B, S, H, nd + rd)
    q_rope = rope(q[..., nd:], positions, cfg.rope_theta)
    kv_a = x @ p.wkv_a
    c_kv = rms_norm(kv_a[..., :a.kv_lora_rank], p.kv_norm)
    k_rope = rope(kv_a[..., None, a.kv_lora_rank:], positions,
                  cfg.rope_theta)                 # (B, S, 1, rd), shared
    kv = (c_kv @ p.wkv_b).reshape(B, S, H, nd + vd)
    k = torch.cat([kv[..., :nd], k_rope.expand(B, S, H, rd)], dim=-1)
    q_full = torch.cat([q[..., :nd], q_rope], dim=-1)
    o = flash_attention(q_full, k, kv[..., nd:], causal=True,
                        scale=1.0 / math.sqrt(nd + rd), backend=backend)
    return o.reshape(B, S, H * vd) @ p.wo, c_kv, k_rope[..., 0, :]


def mla_decode(x, p, cfg, c_kv_cache, k_rope_cache, cache_len, position):
    """Absorbed MLA decode: one token a sequence attends in the kv_lora
    latent space, W_uk folded into q and W_uv applied after, in f32.
    c_kv_cache (B, S, kvr) and k_rope_cache (B, S, rope) already hold the
    new token's entries; ``cache_len`` and ``position`` are ints or (B,)
    tensors."""
    a = cfg.mla
    B, Sq, D = x.shape
    if Sq != 1:
        raise ValueError(f"mla_decode takes one token, got {Sq}")
    H = cfg.n_heads
    nd, rd, vd = a.nope_head_dim, a.rope_head_dim, a.v_head_dim
    kvr = a.kv_lora_rank
    q_lat = rms_norm(x @ p.wq_a, p.q_norm)
    q = (q_lat @ p.wq_b).reshape(B, 1, H, nd + rd)
    pos_bs = torch.as_tensor(position, device=x.device).broadcast_to(
        (B,))[:, None]
    q_rope = rope(q[..., nd:], pos_bs, cfg.rope_theta)
    wkv_b = p.wkv_b.reshape(kvr, H, nd + vd)
    w_uk, w_uv = wkv_b[..., :nd].float(), wkv_b[..., nd:].float()
    q_abs = torch.einsum("bqhn,rhn->bqhr", q[..., :nd].float(), w_uk)
    scale = 1.0 / math.sqrt(nd + rd)
    s = torch.einsum("bqhr,bsr->bhqs", q_abs, c_kv_cache.float()) * scale
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float() * scale,
                         k_rope_cache.float())
    kv_pos = torch.arange(c_kv_cache.shape[1], device=x.device)
    clen = torch.as_tensor(cache_len, device=x.device).broadcast_to(
        (B,))[:, None]
    s = torch.where((kv_pos[None, :] < clen)[:, None, None, :], s,
                    _NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", prob, c_kv_cache.float())
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    return o.to(x.dtype).reshape(B, 1, H * vd) @ p.wo


def mla_new_cache_entries(x, p, cfg, position):
    """The (c_kv (B, 1, kvr), k_rope (B, 1, rope)) entries of one new
    token a sequence; ``position``: an int or (B,) positions."""
    a = cfg.mla
    B = x.shape[0]
    kv_a = x @ p.wkv_a
    c_kv = rms_norm(kv_a[..., :a.kv_lora_rank], p.kv_norm)
    pos_bs = torch.as_tensor(position, device=x.device).broadcast_to(
        (B,))[:, None]
    k_rope = rope(kv_a[..., None, a.kv_lora_rank:], pos_bs,
                  cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope
