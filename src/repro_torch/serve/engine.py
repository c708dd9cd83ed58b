"""Batched serving engine: fixed-slot continuous batching (the twin of
``repro.serve.engine``).

Each of B cache slots holds one request.  Per-slot positions (the (B,)
``pos`` of ``serve_step``) let slots sit at different sequence lengths:
new requests are admitted into free slots while others keep decoding.
Admission replays the prompt through decode steps, as the JAX engine
does (there is no prefill admission in either).

Protocol per slot: ``pending`` is the token to feed next at ``next_pos``;
feeding it yields the logits that pick the following token.  The cache
(``transformer.init_cache``'s, by family: k/v per layer, MLA's latent
caches for deepseek-v2, the nested ``SSMCache`` of the ssm and hybrid
families) lives on the params' device and is written in place by each
step.

A recurrent cache inherits the JAX engine's lock-step protocol as it is:
admission's replay steps every slot, so the other slots' SSM state
advances on their pending token, and a reused slot starts from the
state its last request left (a KV cache masks both by ``cache_len``; a
recurrent state cannot).  The port mirrors the reference here, token for
token (``tests/test_torch_ssm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.step import serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_seq: int = 256, sample: str = "greedy", seed: int = 0,
                 device="cuda"):
        """``device`` ("cuda" by default, which raises without a card)
        must be where ``params`` live."""
        if cfg.family in ("audio", "vlm"):
            raise ValueError("the engine drives text decoders")
        if params.embed.device.type != resolve_device(device).type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {device}")
        self.device = params.embed.device
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.S = max_seq
        self.rng = np.random.default_rng(seed)
        self.sample = sample
        self.cache = transformer.init_cache(cfg, batch_slots, max_seq,
                                            device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.pending = np.zeros(batch_slots, np.int32)
        self.next_pos = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.n_decode_steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _step_tokens(self, token_vec: np.ndarray, pos_vec: np.ndarray):
        logits, self.cache = serve_step(
            self.cfg, self.params, self.cache,
            {"token": torch.as_tensor(token_vec[:, None].astype(np.int64),
                                      device=self.device),
             "pos": torch.as_tensor(pos_vec.astype(np.int64),
                                    device=self.device)})
        self.n_decode_steps += 1
        return logits[:, 0].cpu().numpy()

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.pop(0)
            # replay prompt[:-1]; positions of other slots stay put (their
            # writes land at their own next_pos and are re-written on their
            # next real step, beyond their valid cache_len: harmless).
            for t, tok in enumerate(req.prompt[:-1]):
                token = self.pending.copy()
                token[slot] = tok
                pos = self.next_pos.copy()
                pos[slot] = t
                self._step_tokens(token, pos)
            self.slot_req[slot] = req
            self.pending[slot] = int(req.prompt[-1])
            self.next_pos[slot] = len(req.prompt) - 1

    def _pick(self, logits: np.ndarray) -> int:
        if self.sample == "greedy":
            return int(logits.argmax())
        logits = logits.astype(np.float64)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(logits.shape[-1], p=p))

    def step(self) -> bool:
        """One lock-step decode over all active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        logits = self._step_tokens(self.pending.copy(),
                                   self.next_pos.copy())
        for i in active:
            r = self.slot_req[i]
            nxt = self._pick(logits[i])
            r.out_tokens.append(nxt)
            self.pending[i] = nxt
            self.next_pos[i] += 1
            if (len(r.out_tokens) >= r.max_new_tokens
                    or (r.eos_id is not None and nxt == r.eos_id)
                    or self.next_pos[i] >= self.S - 1):
                r.done = True
                self.slot_req[i] = None
                self.pending[i] = 0
                self.next_pos[i] = 0
        return True

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                return
