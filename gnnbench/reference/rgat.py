"""R-GAT, OGB-LSC MAG240M's relational GAT baseline (arXiv:2103.09430;
``examples/lsc/mag240m/rgnn.py --model rgat`` in snap-stanford/ogb), in
eval mode, in plain PyTorch f32.  For each layer, with relations r as
``relation_table`` numbers them, heads h of width dh, and slot f of
target i with source j = nbr[i, f] and relation r(i, f) set by the type
blocks of i and j (``node_offsets``):

    z_r[j]    = x_j W_r                 (GATConv's lin_dst is its lin_src)
    e[i,f,h]  = LeakyReLU_0.2(<z_r[j]_h, a_src[r,h]> + <(x_i W_r)_h, a_dst[r,h]>)
    alpha     = softmax of e over i's live slots of relation r(i,f), per head
    out[i]    = x_i W_skip + b_skip + sum_r b_r + sum_f alpha[i,f,h] z_r[j]_h
    x'[i]     = ELU((out[i] - mean) / sqrt(var + 1e-5) * weight + bias)

(heads concatenated; 0 where a row has no slot of a relation; no
self-loops, as rgnn.py's ``add_self_loops=False``; ``sum_r b_r`` on every
row, as rgnn.py adds each relation's GATConv bias to every target of a
batch that holds an edge of it, and at all-node scope every relation has
one).  After the last layer, the head over every node:

    y = ReLU(BN_h(x W_1 + b_1)) W_2 + b_2

Each relation's softmax and attend run over the target rows of its
destination type, in blocks of rows; every GEMM runs in blocks of rows
(``mm`` is the reference's f32 GEMM, or the control's TF32), and
BatchNorm and ELU in place, so that it fits beside the program's output
on the card.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from gnnbench import inputs

NEGATIVE_SLOPE = 0.2
BN_EPS = 1e-5
BLOCK_ROWS = 1 << 14       # target rows of one softmax and attend
GEMM_BLOCK = 1 << 16       # rows of one GEMM call


def layer_widths(cfg: Dict) -> List[Tuple[int, int]]:
    """(768, 1024), (1024, 1024) for MAG240M's R-GAT: ``d_feature`` into
    the first layer, ``hidden_size`` out of each."""
    d = [int(cfg["d_feature"])] + [int(cfg["hidden_size"])] * int(
        cfg["n_layers"])
    return list(zip(d[:-1], d[1:]))


def _bn(d: int) -> Dict:
    """Eval BatchNorm's four vectors, drawn: the running mean normal, the
    running variance in [1, 3) (a layer's pre-norm sum of its skip and
    up to two relations' attends), the scale in [0.5, 1.5)."""
    return {"bn_mean": ((d,), 0.1), "bn_var": ((d,), (1.0, 3.0)),
            "bn_weight": ((d,), (0.5, 1.5)), "bn_bias": ((d,), 0.1)}


def param_shapes(cfg: Dict) -> Dict:
    """Each layer: the relations' weights stacked (R, d_in, d_out), their
    attention vectors (R, heads, dh) at standard deviation dh ** -0.5
    (so a head's score is of order 1), a bias each (R, d_out), the skip
    Linear, BatchNorm; the head: Linear, BatchNorm, Linear into
    ``n_classes``."""
    R, H = len(cfg["relations"]), int(cfg["heads"])
    hid, C = int(cfg["hidden_size"]), int(cfg["n_classes"])
    layers = []
    for a, b in layer_widths(cfg):
        dh = b // H
        layers.append({"w_rel": ((R, a, b), "fan_in"),
                       "a_src": ((R, H, dh), dh ** -0.5),
                       "a_dst": ((R, H, dh), dh ** -0.5),
                       "b_rel": ((R, b), 0.1),
                       "w_skip": ((a, b), "fan_in"), "b_skip": ((b,), 0.1),
                       **_bn(b)})
    head = {"w1": ((hid, hid), "fan_in"), "b1": ((hid,), 0.1), **_bn(hid),
            "w2": ((hid, C), "fan_in"), "b2": ((C,), 0.1)}
    return {"layers": layers, "head": head}


def relation_pairs(table) -> List[Tuple[int, int, int]]:
    """(relation, target type, source type) of each entry of the relation
    table, in relation order, then target type."""
    return sorted((r, dt, st) for dt, row in enumerate(table)
                  for st, r in enumerate(row) if r >= 0)


def relation_rows(cfg: Dict, n_nodes: int) -> int:
    """The rows that one layer's relations project: each relation's
    source types' rows, a type once a relation."""
    b = inputs.typed_blocks(dict(cfg, n_nodes=n_nodes))
    off = b["node_offsets"]
    pairs = {(r, st) for r, _, st in relation_pairs(b["relation_table"])}
    return sum(off[st + 1] - off[st] for _, st in pairs)


def epoch_flops(cfg: Dict, n_nodes: int, widths, stats) -> int:
    """Per layer (d_in, d_out): the skip GEMM over every row, each
    relation's GEMM over its source types' rows (``relation_rows``), the
    attention dots (a_src with each projected row, a_dst with each row's
    projection by each relation into its type, d_out wide each), and the
    attend, 2 nnz d_out; then the head's two GEMMs over every row."""
    b = inputs.typed_blocks(dict(cfg, n_nodes=n_nodes))
    off = b["node_offsets"]
    src_rows = relation_rows(cfg, n_nodes)
    dst_pairs = sum(off[dt + 1] - off[dt]
                    for _, dt, _ in relation_pairs(b["relation_table"]))
    total = 0
    for (di, do), st in zip(widths, stats):
        total += (2 * n_nodes * di * do + 2 * src_rows * di * do
                  + 2 * (src_rows + dst_pairs) * do + 2 * st["nnz"] * do)
    hid, C = int(cfg["hidden_size"]), int(cfg["n_classes"])
    return total + 2 * n_nodes * hid * hid + 2 * n_nodes * hid * C


def _gemm(h, w, mm):
    """h @ w by ``mm`` in blocks of ``GEMM_BLOCK`` rows."""
    out = torch.empty((h.shape[0], w.shape[1]), dtype=torch.float32,
                      device=h.device)
    for r0 in range(0, h.shape[0], GEMM_BLOCK):
        out[r0:r0 + GEMM_BLOCK] = mm(h[r0:r0 + GEMM_BLOCK], w)
    return out


def _batch_norm_(x, p):
    """Eval BatchNorm, in place: (x - mean) / sqrt(var + eps) * weight +
    bias."""
    return (x.sub_(p["bn_mean"]).div_(torch.sqrt(p["bn_var"] + BN_EPS))
            .mul_(p["bn_weight"]).add_(p["bn_bias"]))


def layer(h, nbr, mask, p, off, table, heads: int, mm):
    """One R-GAT layer over every row: (N, d_out), before BatchNorm."""
    d_out = p["w_skip"].shape[1]
    dh = d_out // heads
    out = _gemm(h, p["w_skip"], mm)
    out += p["b_skip"] + p["b_rel"].sum(dim=0)
    for r, dt, st in relation_pairs(table):
        w = p["w_rel"][r]
        z = _gemm(h[off[st]:off[st + 1]], w, mm).reshape(-1, heads, dh)
        s_src = torch.empty(z.shape[:2], dtype=torch.float32,
                            device=z.device)                   # (n_st, H)
        for r0 in range(0, z.shape[0], GEMM_BLOCK):
            s_src[r0:r0 + GEMM_BLOCK] = (z[r0:r0 + GEMM_BLOCK]
                                         * p["a_src"][r]).sum(dim=-1)
        for r0 in range(off[dt], off[dt + 1], BLOCK_ROWS):
            r1 = min(r0 + BLOCK_ROWS, off[dt + 1])
            ids = nbr[r0:r1]
            m = mask[r0:r1] & (ids >= off[st]) & (ids < off[st + 1])
            loc = torch.where(m, ids - off[st], torch.zeros_like(ids))
            zt = mm(h[r0:r1], w).reshape(-1, heads, dh)
            s_dst = (zt * p["a_dst"][r]).sum(dim=-1)           # (b, H)
            e = torch.nn.functional.leaky_relu(
                s_src[loc] + s_dst[:, None, :], NEGATIVE_SLOPE)
            mh = m[:, :, None]
            alpha = torch.softmax(torch.where(mh, e, -1e30), dim=1) * mh
            out[r0:r1] += torch.einsum("bfh,bfhd->bhd", alpha,
                                       z[loc]).reshape(-1, d_out)
        del z, s_src
        _release(out.device)
    return out


def _release(device) -> None:
    """Hand the freed blocks back to the card, so that the next
    relation's table, of another size, finds room beside the layer's
    input and output."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def embed(h, layer_graphs, tree, mm):
    """Every node's 153 logits (``n_classes``): the layers, each through
    its BatchNorm and ELU, then the head."""
    dev = h.device
    off = [int(x) for x in tree["node_offsets"]]
    table = tree["relation_table"]
    heads = int(tree.get("heads", 1))

    def params(d):
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in d.items()}
    for l, (nbr, mask) in enumerate(layer_graphs):
        p = params(tree["layers"][l])
        out = layer(h, torch.as_tensor(nbr, device=dev).long(),
                    torch.as_tensor(mask, device=dev), p, off, table, heads,
                    mm)
        h = None
        h = torch.nn.functional.elu(_batch_norm_(out, p), inplace=True)
        del out
        _release(dev)
    hp = params(tree["head"])
    y = torch.empty((h.shape[0], hp["w2"].shape[1]), dtype=torch.float32,
                    device=dev)
    for r0 in range(0, h.shape[0], GEMM_BLOCK):
        t = torch.relu(_batch_norm_(mm(h[r0:r0 + GEMM_BLOCK], hp["w1"])
                                    + hp["b1"], hp))
        y[r0:r0 + GEMM_BLOCK] = mm(t, hp["w2"]) + hp["b2"]
    return y
