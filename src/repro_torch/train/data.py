"""Data pipeline — the twin of ``repro.train.data``, in numpy: the same
seed gives the same batches, bit for bit.

The synthetic stream is a noisy order-2 Markov chain (learnable, so a
training run shows a real loss curve); the file pipeline memory-maps a
token .npy; ``make_pipeline`` prefetches on a host thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    corpus_path: Optional[str] = None


def _markov_tables(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    # sparse order-2 structure: each (a, b) strongly prefers 4 successors
    return rng.integers(0, vocab, size=(vocab, 4))


def synthetic_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    prefer = _markov_tables(cfg.vocab_size, cfg.seed + 1)
    B, S = cfg.batch_size, cfg.seq_len
    while True:
        tok = np.empty((B, S + 1), np.int32)
        tok[:, 0] = rng.integers(0, cfg.vocab_size, B)
        for t in range(S):
            choice = prefer[tok[:, t], rng.integers(0, 4, B)]
            noise = rng.integers(0, cfg.vocab_size, B)
            use_noise = rng.random(B) < 0.1
            tok[:, t + 1] = np.where(use_noise, noise, choice)
        yield {"tokens": tok[:, :S], "labels": tok[:, 1:]}


def file_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    data = np.load(cfg.corpus_path, mmap_mode="r")
    B, S = cfg.batch_size, cfg.seq_len
    n = (data.shape[0] - 1) // S
    rng = np.random.default_rng(cfg.seed)
    while True:
        idx = rng.integers(0, n, B)
        tok = np.stack([data[i * S:i * S + S + 1] for i in idx])
        yield {"tokens": tok[:, :S].astype(np.int32),
               "labels": tok[:, 1:].astype(np.int32)}


def make_pipeline(cfg: DataConfig, prefetch: int = 2
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-thread prefetching wrapper."""
    src = (file_batches(cfg) if cfg.corpus_path else synthetic_batches(cfg))
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        for b in src:
            if stop.is_set():
                return
            q.put(b)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
