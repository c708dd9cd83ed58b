"""Top-k MoE with sort-based capacity dispatch — the twin of
``repro.models.moe``.

Tokens are sorted by expert id (a stable sort, as ``jnp.argsort``), each
takes a position in its expert's bucket, and the first C of a bucket in
token order go into an (E, C, D) buffer (capacity C; the rest are
dropped, as capacity MoEs drop them).  The expert FFN is one batched
``torch.bmm`` a projection over E.  The JAX package has no Pallas kernel
here, so neither has the port: dispatch and combine are PyTorch ops.

What decides whether the two packages agree, and how the port keeps it:

- top-k takes ties toward the lower expert id, as ``jax.lax.top_k``
  does: a stable descending sort of the f32 router probabilities;
- the combine adds each token's K expert rows in ascending expert id,
  in the activation dtype, starting from zero: the order of XLA's
  sequential scatter-add on the CPU.  It inverts the sort permutation
  and gathers, so no atomic add (``index_add_`` on CUDA) makes the bits
  depend on the run.

  moe_block(x, p, cfg)        -> (out (B, S, D), Switch aux loss)
  moe_block_stats(x, p, cfg)  -> the same and the loss's statistics
  route / dispatch / moe_ffn / combine: its steps, for timing
  init_moe_params(gen, cfg, dtype)

Under ``tuning.on("moe_ep")`` and a mesh in ``sharding.context``,
``moe_block`` runs the expert-parallel ``_moe_block_ep`` (JAX's
``shard_map`` path): each model shard dispatches to its own experts and
the partial outputs are summed.  With experts placed by the sharding
rules (``sharding.placement``) every model shard works on its own card
and only tokens and partial outputs cross; with plain expert tensors on
the mesh's home the shards are views of them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tuning
from repro_torch.launch.mesh import check_mesh
from repro_torch.models.layers import normal_init
from repro_torch.sharding.context import current_mesh
from repro_torch.sharding.placement import Placed, gather, gather_slab, move
from repro_torch.sharding.specs import logical_axes, shard_if_divisible


def is_routed_expert(name: str) -> bool:
    """Whether a parameter name (``...moe.w_gate``) is a routed expert
    weight, which ``_moe_block_ep`` runs where its blocks lie."""
    return name.split(".")[-2:] in (["moe", "w_gate"], ["moe", "w_up"],
                                    ["moe", "w_down"])


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(n_tokens * top_k / n_experts * factor) + 1
    return max(c, 4)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MoE(nn.Module):
    """router (D, E) f32; w_gate and w_up (E, D, F), w_down (E, F, D);
    shared_w_gate and shared_w_up (D, Fs), shared_w_down (Fs, D) when the
    config has shared experts (Fs = F x their number)."""

    def __init__(self, router, w_gate, w_up, w_down, shared_w_gate=None,
                 shared_w_up=None, shared_w_down=None):
        super().__init__()
        self.router = _param(router)
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))
        shared = (shared_w_gate, shared_w_up, shared_w_down)
        self.shared_w_gate, self.shared_w_up, self.shared_w_down = (
            None if w is None else _param(w) for w in shared)



def init_moe_params(gen: torch.Generator, cfg, dtype) -> MoE:
    """normal(0.02) router (f32) and expert weights, as the JAX package
    draws them (from a ``torch.Generator``: other numbers).  Expert
    tensors are drawn one expert at a time, so the f32 draw of a bf16
    (E, D, F) tensor never holds more than one expert's worth at once."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    dev = gen.device

    def experts(shape):
        out = torch.empty((E,) + shape, dtype=dtype, device=dev)
        for e in range(E):
            out[e] = normal_init(gen, shape, dtype)
        return out

    p = dict(router=normal_init(gen, (D, E), torch.float32),
             w_gate=experts((D, Fe)), w_up=experts((D, Fe)),
             w_down=experts((Fe, D)))
    if m.n_shared_experts:
        Fs = Fe * m.n_shared_experts
        p.update(shared_w_gate=normal_init(gen, (D, Fs), dtype),
                 shared_w_up=normal_init(gen, (D, Fs), dtype),
                 shared_w_down=normal_init(gen, (Fs, D), dtype))
    return MoE(**p)


class Routing(NamedTuple):
    """One dispatch: ``probs`` (T, E) f32 and ``expert`` (T, K) from the
    router; ``slot`` (T K,) each sorted token-slot's row of the (E C + 1)
    buffer (E C: dropped); ``tok`` (T K,) its token; ``gate`` (T K,) its
    f32 gate with dropped slots 0; ``keep`` (T K,) bool; ``inv`` (T, K)
    the sorted positions of each token's K slots, in ascending expert
    id."""
    probs: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    tok: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    inv: torch.Tensor


def route(flat, router, n_experts: int, top_k: int, capacity: int, *,
          expert_offset: int = 0) -> Routing:
    """Router logits in f32, softmax, top-k (ties to the lower id),
    renormalized gates, and the sort-based slot of every (token, k) over
    ``n_experts`` experts from ``expert_offset`` on (JAX's
    ``_dispatch_compute``): a slot routed outside them is dropped, as
    one over the capacity is."""
    T = flat.shape[0]
    E, K, C = n_experts, top_k, capacity
    dev = flat.device
    logits = flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :K], expert[:, :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    eflat = expert.reshape(T * K) - expert_offset
    eflat = torch.where((eflat >= 0) & (eflat < E), eflat, E)  # E: drop
    n = torch.arange(T * K, device=dev)
    order = torch.argsort(eflat, stable=True)
    es, ts, gs = eflat[order], n[order] // K, gate.reshape(T * K)[order]
    starts = torch.searchsorted(es, torch.arange(E, device=dev))
    pos = n - starts[es.clamp(max=E - 1)]
    keep = (pos < C) & (es < E)
    slot = torch.where(keep, es * C + pos, E * C)
    inv = torch.empty_like(order)
    inv[order] = n
    # a token's slots sorted by position: its experts in ascending id
    inv = inv.reshape(T, K).sort(dim=1).values
    return Routing(probs, expert, slot, ts, gs * keep, keep, inv)


def dispatch(flat, r: Routing, n_experts: int, capacity: int):
    """The (E, C, D) expert buffer: each kept slot's token row, zeros
    elsewhere (dropped slots all write zeros to the scratch row E C)."""
    E, C, D = n_experts, capacity, flat.shape[1]
    buf = torch.zeros((E * C + 1, D), dtype=flat.dtype, device=flat.device)
    buf[r.slot] = flat[r.tok] * r.keep[:, None].to(flat.dtype)
    return buf[:-1].reshape(E, C, D)


def moe_ffn(buf, w_gate, w_up, w_down):
    """buf: (E, C, D); expert weights (E, D, F) / (E, F, D)."""
    g = F.silu(torch.bmm(buf, w_gate))
    u = torch.bmm(buf, w_up)
    return torch.bmm(g * u, w_down)


def combine(out_buf, r: Routing):
    """(T, D): each token's K expert rows times their gates, added from
    zero in ascending expert id in the activation dtype."""
    E, C, D = out_buf.shape
    out_flat = torch.cat([out_buf.reshape(E * C, D),
                          out_buf.new_zeros((1, D))])
    gathered = out_flat[r.slot] * r.gate[:, None].to(out_buf.dtype)
    rows = gathered[r.inv]                                  # (T, K, D)
    out = torch.zeros_like(rows[:, 0])
    for k in range(rows.shape[1]):
        out = out + rows[:, k]
    return out


def shared_ffn(flat, p: MoE):
    g = F.silu(flat @ p.shared_w_gate)
    return (g * (flat @ p.shared_w_up)) @ p.shared_w_down


def moe_block(x, p: MoE, cfg):
    """x: (B, S, D).  Returns (out (B, S, D), aux_loss f32 0-d): the
    routed experts at capacity C, plus the always-on shared experts, and
    the Switch load-balance loss E * sum(mean prob x top-1 share).

    With REPRO_TUNING=moe_ep and a mesh in ``sharding_context``, the
    dispatch runs expert-parallel (``_moe_block_ep``)."""
    out, aux, _ = moe_block_stats(x, p, cfg)
    return out, aux


def moe_block_stats(x, p: MoE, cfg):
    """``moe_block``, with the Switch loss's statistics beside it: (out,
    aux_loss, (the router's probs summed over the tokens (E,), the top-1
    counts (E,), the token count)), from which a data-parallel step
    builds the whole batch's aux loss; None for the statistics under
    moe_ep, whose aux loss is each data shard's, averaged."""
    mesh = current_mesh()
    if tuning.on("moe_ep") and mesh is not None:
        return (*_moe_block_ep(x, p, cfg, mesh), None)
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = _capacity(T, E, K, m.capacity_factor)
    flat = x.reshape(T, D)
    r = route(flat, p.router, E, K, C)
    me = r.probs.mean(dim=0)
    top1 = F.one_hot(r.expert[:, 0], E).float()
    ce = top1.mean(dim=0)
    aux = E * torch.sum(me * ce)
    out = combine(moe_ffn(dispatch(flat, r, E, C), p.w_gate, p.w_up,
                          p.w_down), r)
    if m.n_shared_experts:
        out = out + shared_ffn(flat, p)
    return out.reshape(B, S, D), aux, (r.probs.sum(dim=0), top1.sum(dim=0),
                                       T)


def _moe_block_ep(x, p: MoE, cfg, mesh):
    """Expert-parallel MoE, JAX's ``shard_map`` path; x on the mesh's
    home.

    The tokens split over the data-parallel shards (when B divides over
    them; else data shard 0 takes them all, as every data shard would
    compute the same) and are replicated over ``model``; model shard m
    dispatches every local token to its experts [m E/M, (m + 1) E/M)
    only, at the capacity of the local tokens over all E experts.  The
    shards' partial outputs (zero where a token was not routed there)
    are summed in shard order in the activation dtype, where JAX psums
    them over ``model``.  The aux loss is each data shard's Switch loss,
    averaged over them (JAX's pmean); the shared experts are added after,
    on the home.

    With ``Placed`` experts, shard (p, m) runs on ``mesh.device(p, m)``:
    data shard p's tokens go out to it ("tokens"), it routes with the
    router gathered there ("params") and runs its experts' block where it
    lies (gathered over ``data`` only if the rules split their FSDP dim:
    "experts"), and the (T_loc, D) partials come back to ``device(p,
    0)`` ("partials"), their sum and the aux loss to the home.  With plain
    expert tensors the shards are views of them on x's device."""
    check_mesh(mesh, x.device)
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    M = mesh.shape["model"]
    if E % M:
        raise ValueError(f"moe_ep: {E} experts do not divide over {M} "
                         "model shards")
    placed = isinstance(p.w_gate, Placed)
    E_loc = E // M
    dp = logical_axes(mesh)["dp"]
    b_ax = shard_if_divisible(mesh, B, dp)
    B_loc = B if b_ax is None else B // math.prod(mesh.shape[a] for a in dp)
    T_loc = B_loc * S
    C = _capacity(T_loc, E, K, m.capacity_factor)

    def to(t, pi, mi, kind):        # shard (pi, mi)'s copy of a home value
        if not placed or (pi, mi) == (0, 0):
            return t
        return move(mesh, kind, t, pi * M + mi, 0)

    def back(t, pi, mi, kind):      # -> shard (pi, 0); home for mi < 0
        if not placed or mi == 0 or (mi < 0 and pi == 0):
            return t
        return (move(mesh, kind, t, pi * M, pi * M + mi) if mi > 0
                else move(mesh, kind, t, 0, pi * M))

    outs, auxes = [], []
    for pi, xd in enumerate(x.split(B_loc)):    # the data shards' tokens
        flat = xd.reshape(T_loc, D)
        out = aux = None
        for mi in range(M):                     # the model shards, in order
            lo = mi * E_loc
            xin = to(flat, pi, mi, "tokens")
            if placed:
                shard = pi * M + mi
                router = (gather(p.router, shard)
                          if isinstance(p.router, Placed)
                          else to(p.router, pi, mi, "params"))
                w = [expert_block(t, mi, E_loc, shard)
                     for t in (p.w_gate, p.w_up, p.w_down)]
            else:
                router = p.router
                w = [t[lo:lo + E_loc] for t in (p.w_gate, p.w_up, p.w_down)]
            r = route(xin, router, E_loc, K, C, expert_offset=lo)
            part = back(combine(moe_ffn(dispatch(xin, r, E_loc, C), *w), r),
                        pi, mi, "partials")
            out = part if out is None else out + part
            if mi == 0:     # every model shard routes alike: one aux loss
                ce = F.one_hot(r.expert[:, 0], E).float().mean(dim=0)
                aux = E * torch.sum(r.probs.mean(dim=0) * ce)
        outs.append(back(out, pi, -1, "partials"))
        auxes.append(back(aux, pi, -1, "partials"))
    out = torch.cat(outs).reshape(B, S, D)
    aux = auxes[0] if b_ax is None else torch.stack(auxes).mean()
    if m.n_shared_experts:
        out = out + shared_ffn(x.reshape(B * S, D), p).reshape(B, S, D)
    return out, aux


def expert_block(t: Placed, mi: int, E_loc: int, shard: int):
    """Model shard mi's E_loc experts, with every other dim whole, on
    ``shard`` (one of ``t``'s mesh's shards at model index mi): the
    shard's own block when the rules split the experts over ``model``
    alone; gathered over ``data`` there when they also split the FSDP
    dim."""
    slab = gather_slab(t, {"model": mi}, shard, "experts")
    start = min(r[0][0] for i, r in enumerate(t.ranges)
                if i % t.mesh.M == mi)
    return slab[mi * E_loc - start:(mi + 1) * E_loc - start]
