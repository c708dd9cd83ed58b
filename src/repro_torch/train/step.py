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

from repro_torch import tuning
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.moe import expert_block, is_routed_expert
from repro_torch.sharding.context import sharding_context
from repro_torch.sharding.placement import (Placed, View, _slices, gather,
                                            gather_slab, has_placed,
                                            materialize, move, scatter,
                                            send)
from repro_torch.train.loss import chunked_nll
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_leaf,
                                         adamw_update, lr_schedule)

AUX_LOSS_WEIGHT = 0.01


def _head(cfg: ModelConfig, params):
    return (params.embed.T.to(transformer.torch_dtype(cfg))
            if cfg.tie_embeddings else params.lm_head)


def _terms(cfg: ModelConfig, params, batch: Dict[str, Any],
           attn_backend: str):
    """(summed NLL, unmasked count, aux loss, the MoE layers' Switch
    statistics) of ``batch``."""
    hidden, (aux, stats) = transformer.forward(
        cfg, params, batch, mode="train", return_hidden=True,
        attn_backend=attn_backend, switch_stats=True)
    labels = torch.as_tensor(batch["labels"], device=hidden.device)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.n_frontend_tokens:]
    tot, cnt = chunked_nll(hidden, _head(cfg, params), labels)
    return tot, cnt, aux, stats


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            attn_backend: str = "cuda"):
    """The CE over the labels plus ``AUX_LOSS_WEIGHT`` times the MoE
    aux loss; vlm scores its text positions only.  batch: the forward's
    inputs and "labels" (B, S_text) int."""
    tot, cnt, aux, _ = _terms(cfg, params, batch, attn_backend)
    ce = tot / torch.clamp(cnt, min=1.0)
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
    grad_norm, lr, loss (the CE), aux_loss, total_loss.  With params and
    state placed on a mesh (``launch.train.run(mesh=)``) the step is data
    parallel (``_placed_train_step``)."""
    if has_placed(params):
        return _placed_train_step(cfg, opt_cfg, params, opt_state, batch,
                                  attn_backend)
    (total, (ce, aux)), grads = loss_and_grads(cfg, params, batch,
                                               attn_backend=attn_backend)
    params, opt_state, metrics = adamw_update(
        params, grads, opt_state, opt_cfg, decay=decay_mask(cfg, params))
    metrics.update({"loss": ce, "aux_loss": aux, "total_loss": total})
    return params, opt_state, metrics


# ----------------------------------------------------------------------
# data parallel over a mesh: params and AdamW state placed
# ----------------------------------------------------------------------

def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


def _shard_rows(batch, mesh, p: int):
    """Data shard p's batch rows on ``mesh.device(p, 0)``: its block of a
    batch placed by ``batch_specs``, or its rows of a plain one on the
    home."""
    P, shard = mesh.P, p * mesh.M
    out = {}
    for k, v in batch.items():
        if isinstance(v, Placed):
            if v.spec[0] is None and P > 1:
                raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not "
                                 f"split over {P} data shards")
            out[k] = gather_slab(v, mesh.shard_coords[shard], shard,
                                 "batch")
            continue
        v = torch.as_tensor(v, device=mesh.home)
        if v.shape[0] % P:
            raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not split "
                             f"over {P} data shards")
        n = v.shape[0] // P
        rows = v[p * n:(p + 1) * n]
        out[k] = rows if p == 0 else move(mesh, "batch", rows, shard, 0)
    return out


def _working_copy(params, mesh, p: int, ep: bool):
    """Data shard p's params: each gathered whole onto ``device(p, 0)``
    as a fresh leaf, but for the experts under ``moe_ep``, which become
    M leaves, model shard m's experts on ``device(p, m)`` (a ``Placed``
    over the row ``mesh.row(p)``).  Returns (the module, {name: [(leaf,
    its origin in the global tensor, its shard)]})."""
    row = mesh.row(p)
    leaves: Dict[str, list] = {}

    def fn(n, x):
        if ep and is_routed_expert(n):
            e_loc = x.shape[0] // mesh.M
            blocks = [_leaf(expert_block(x, m, e_loc, p * mesh.M + m))
                      for m in range(mesh.M)]
            leaves[n] = [(b, (m * e_loc,) + (0,) * (x.ndim - 1),
                          p * mesh.M + m) for m, b in enumerate(blocks)]
            return Placed(row, ("model",) + (None,) * (x.ndim - 1), x.shape,
                          x.dtype, blocks)
        t = _leaf(gather(x, p * mesh.M))
        leaves[n] = [(t, (0,) * x.ndim, p * mesh.M)]
        return t

    return materialize(params, fn=fn), leaves


def _intersect(a, b):
    """The overlap of two ranges ((start, stop) per dim), or None."""
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return out if all(x0 < x1 for x0, x1 in out) else None


def _reduce_grads(named, grads, mesh):
    """Each block's gradient on its card: the piece of every data shard's
    gradients that covers it (the whole parameter, or under ``moe_ep``
    its model shard's experts), copied there ("grads") and summed in
    shard order.  Replicas of a block each get the same sum, the same
    way.  Returns {name: [gradient of block i]}.

    Shard i receives its blocks' pieces into one flat buffer a dtype, a
    row a data shard and its blocks side by side, so the sums are P - 1
    adds of whole rows: elementwise the same adds in the same order."""
    P = len(grads)
    flat: Dict[tuple, list] = {}        # (shard, dtype) -> [(n, block)]
    for n, x in named.items():
        for i, (rng, blk) in enumerate(zip(x.ranges, x.blocks)):
            pieces = []
            for shard in grads:
                for g, origin, frm in shard[n]:
                    grng = tuple((o, o + d) for o, d in zip(origin, g.shape))
                    inter = _intersect(rng, grng)
                    if inter is not None:
                        pieces.append((inter, g, origin, frm))
            if len(pieces) != P or any(p[0] != rng for p in pieces):
                raise ValueError(f"{n}: block {i} is not one whole piece "
                                 "of each data shard's gradient")
            flat.setdefault((i, blk.dtype), []).append((n, blk, pieces))
    msgs, bufs = [], []
    for (i, dtype), entries in flat.items():
        size = sum(blk.numel() for _, blk, _ in entries)
        buf = torch.empty((P, size), dtype=dtype,
                          device=entries[0][1].device)
        off = 0
        for n, blk, pieces in entries:
            k = blk.numel()
            for p, (inter, g, origin, frm) in enumerate(pieces):
                msgs.append((View(buf, (p, slice(off, off + k)), blk.shape),
                             View(g, _slices(inter, origin)), frm, i))
            off += k
        bufs.append((i, buf, entries))
    send(mesh, "grads", msgs)
    out: Dict[str, list] = {n: [None] * len(x.blocks)
                            for n, x in named.items()}
    for i, buf, entries in bufs:
        acc = buf[0]
        for p in range(1, P):
            acc = acc + buf[p]
        off = 0
        for n, blk, _ in entries:
            out[n][i] = acc[off:off + blk.numel()].view(blk.shape)
            off += blk.numel()
    return out


def _global_aux(cfg: ModelConfig, stats, mesh):
    """The baseline MoE layers' Switch loss over the whole batch, from
    each data shard's per-layer (probs summed, top-1 counts, tokens):
    E sum(me ce) a layer, me and ce the batch's means.  Returns (its
    value on the home, each shard's part of it): shard p's part is E
    sum(its probs summed / T ce) over the layers, whose gradient is the
    shard's share of the whole loss's (ce holds no gradient)."""
    E = cfg.moe.n_experts
    parts = [0] * len(stats)
    aux = 0
    for layer in zip(*stats):
        T = sum(t for _, _, t in layer)
        probs = counts = None
        for p, (ps, cs, _) in enumerate(layer):
            ps, cs = ps.detach(), cs
            if p:
                ps, cs = (move(mesh, "aux", x, 0, p * mesh.M)
                          for x in (ps, cs))
            probs = ps if probs is None else probs + ps
            counts = cs if counts is None else counts + cs
        ce = counts / T
        aux = aux + E * torch.sum(probs / T * ce)
        for p, (ps, _, _) in enumerate(layer):
            ce_p = ce if p == 0 else move(mesh, "aux", ce, p * mesh.M, 0)
            parts[p] = parts[p] + E * torch.sum(ps / T * ce_p)
    return aux, parts


def placed_loss_and_grads(cfg: ModelConfig, params, batch, *,
                          attn_backend: str = "cuda"):
    """``loss_and_grads`` for params placed on a mesh
    (``sharding.placement``), data parallel over ``data``: returns
    ((total, (ce, aux)) on the home, {name: ``Placed`` gradient}, the
    parameter's blocks' layout).

    Each data shard p gathers the params whole onto ``device(p, 0)``
    (under ``moe_ep`` the experts onto ``device(p, m)``, model shard m's
    only: they never cross ``model``), every shard's before any forward,
    and runs the forward and backward there on its batch rows, inside
    ``sharding_context(mesh.row(p))``.
    The loss is the global masked mean: the shards' summed NLL over
    their summed counts.  Under ``moe_ep`` the aux loss is the mean of
    the shards' (JAX's pmean); the baseline ``moe_block``'s is built from
    the whole batch's mean router probabilities and top-1 shares (each
    MoE layer's statistics, from the forward's aux output), as GSPMD
    computes it (``_global_aux``).  Each block's gradient is the
    sum over the data shards, in shard order, on the block's card
    (replicas each get the same sum).  The gathered params and the shards' gradients are
    dropped before it returns."""
    named = dict(params.named_parameters())
    mesh = next(iter(named.values())).mesh
    P = mesh.P
    ep = tuning.on("moe_ep")

    def to_home(t, p):
        return t if p == 0 else move(mesh, "loss", t, 0, p * mesh.M)

    # every shard's params gathered before any compute is queued: a copy
    # out of a card waits for what its compute stream holds, so a gather
    # queued behind shard p - 1's forward would wait for it
    works = [_working_copy(params, mesh, p, ep) for p in range(P)]
    shards, stats = [], []
    for p, (work, leaves) in enumerate(works):
        with sharding_context(mesh.row(p)):
            tot, cnt, aux, st = _terms(cfg, work, _shard_rows(batch, mesh, p),
                                       attn_backend)
        stats.append(st)
        shards.append((leaves, tot, cnt, aux))
    del works, work
    tot = cnt = None
    for p, (_, t, c, _) in enumerate(shards):
        t, c = to_home(t.detach(), p), to_home(c, p)
        tot = t if tot is None else tot + t
        cnt = c if cnt is None else cnt + c
    ce = tot / torch.clamp(cnt, min=1.0)
    if stats[0]:
        aux, parts = _global_aux(cfg, stats, mesh)
    else:
        auxes = [to_home(a.detach(), p) for p, (*_, a) in enumerate(shards)]
        aux = auxes[0] if P == 1 else torch.stack(auxes).mean()
        parts = [a / P for *_, a in shards]
    grads = []
    for p, (leaves, t, _, _) in enumerate(shards):
        c = cnt if p == 0 else move(mesh, "loss", cnt, p * mesh.M, 0)
        loss = t / torch.clamp(c, min=1.0) + AUX_LOSS_WEIGHT * parts[p]
        flat = [leaf for n in leaves for leaf, _, _ in leaves[n]]
        with sharding_context(mesh.row(p)), torch.enable_grad():
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads.append({n: [(torch.zeros_like(leaf) if g is None else g, o,
                           frm) for (leaf, o, frm), g in zip(ls, gs)]
                      for n, ls in leaves.items()})
    del shards
    red = _reduce_grads(named, grads, mesh)
    total = ce + AUX_LOSS_WEIGHT * aux
    return (total, (ce, aux)), {
        n: Placed(mesh, x.spec, x.shape, x.dtype, red[n], x.ranges)
        for n, x in named.items()}


def _adamw_blocks(ps, gs, ms, vs, consts, opt_cfg: AdamWConfig,
                  decay: bool) -> None:
    """``adamw_leaf`` on every block of one parameter (``consts[i]``
    shard i's), the blocks that share a device at once: their flat
    concatenation, written back after (every shard of a one-card or a
    meta mesh).  Every op of the update is elementwise, so each element
    gets the bits it gets alone."""
    by_dev: Dict[torch.device, list] = {}
    for i, p in enumerate(ps):
        by_dev.setdefault(p.device, []).append(i)
    for idx in by_dev.values():
        if len(idx) == 1:
            i = idx[0]
            adamw_leaf(ps[i], gs[i], ms[i], vs[i], *consts[i], opt_cfg,
                       decay)
            continue
        p, g, m, v = (torch.cat([t[i].reshape(-1) for i in idx])
                      for t in (ps, gs, ms, vs))
        adamw_leaf(p, g, m, v, *consts[idx[0]], opt_cfg, decay)
        sizes = [ps[i].numel() for i in idx]
        for ts, flat in ((ps, p), (ms, m), (vs, v)):
            for i, part in zip(idx, flat.split(sizes)):
                ts[i].copy_(part.view(ts[i].shape))


def _placed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
                       opt_state: OptState, batch, attn_backend: str):
    """``train_step`` with params and AdamW state placed on a mesh:
    ``placed_loss_and_grads``, then the global norm over each distinct
    block once, and AdamW on every block of the params, m and v on its
    card (replicas alike; ``_adamw_blocks``), the step counter's
    replicas alike."""
    (total, (ce, aux)), grads = placed_loss_and_grads(
        cfg, params, batch, attn_backend=attn_backend)
    named = dict(params.named_parameters())
    mesh = next(iter(named.values())).mesh
    red = {n: g.blocks for n, g in grads.items()}
    with torch.no_grad():
        sq = 0
        for n, x in named.items():
            seen = set()
            for i, rng in enumerate(x.ranges):
                if rng not in seen:
                    seen.add(rng)
                    s = torch.sum(torch.square(red[n][i].float()))
                    sq = sq + (s if i == 0 else move(mesh, "norm", s, 0,
                                                     i))
        gnorm = torch.sqrt(sq)
        step = gather(opt_state.step) + 1
        lr = lr_schedule(step, opt_cfg)
        scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1c = 1.0 - opt_cfg.b1 ** step.float()
        b2c = 1.0 - opt_cfg.b2 ** step.float()
        consts = [(scale, lr, b1c, b2c)]
        for i in range(1, len(mesh.devices)):
            c = move(mesh, "scalars", torch.stack([scale, lr, b1c, b2c]),
                     i, 0)
            consts.append(tuple(c.unbind()))
        decay = decay_mask(cfg, params)
        for n, x in named.items():
            _adamw_blocks(x.blocks, red[n], opt_state.m[n].blocks,
                          opt_state.v[n].blocks, consts, opt_cfg, decay[n])
        scatter(opt_state.step, step, kind="scalars")
    metrics = {"grad_norm": gnorm, "lr": lr, "loss": ce, "aux_loss": aux,
               "total_loss": total}
    return params, opt_state, metrics
