"""Chunked cross-entropy — the twin of ``repro.train.loss``: it never
holds (B, S, V) logits.

The unembedding and the CE run a sequence chunk at a time, each chunk's
body under ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint`` inside
``lax.scan``), so forward and backward peak at (B, chunk, V).  The JAX
package's ``constrain`` is a sharding hint with nothing to do on one
card, so it is not here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(h, head, labels, mask):
    """Summed masked NLL of one chunk: logits, logsumexp and the gold
    logit in f32."""
    logits = (h @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def chunked_softmax_xent(hidden, head, labels, *, chunk: int = 512,
                         mask=None):
    """hidden: (B, S, D); head: (D, V); labels: (B, S) int.  Returns the
    mean NLL over unmasked positions (f32, 0-d).  A ragged S (vlm's text
    span) is padded to whole chunks with mask 0."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, chunk):
        m = mask[:, s:s + chunk]
        tot = tot + checkpoint(_chunk_nll, hidden[:, s:s + chunk], head,
                               labels[:, s:s + chunk], m,
                               use_reentrant=False)
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
