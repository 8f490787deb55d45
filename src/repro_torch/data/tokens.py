"""Deterministic, seekable token pipeline with straggler-tolerant prefetch:
the port's copy of ``repro.data.tokens`` (numpy and threads, no torch), so
``TokenStream(...).batch(step)`` is the reference's bit for bit.

batch = pure_fn(step): recovery after restart replays the exact stream (the
property an exact resume relies on).  The synthetic corpus is a mixture of
Zipf unigrams and repeated n-gram "documents" so models actually learn
(loss decreases in examples/quickstart.py).

``PrefetchLoader`` issues every batch to a primary worker thread and - if it
misses a deadline - a backup (straggler mitigation at the data layer: the
same hedged-request trick the cluster scheduler uses for compute shards).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, doc_len: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.doc_len = doc_len
        # Zipf unigram table
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._p = (1.0 / ranks ** 1.1)
        self._p /= self._p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        toks = rng.choice(self.vocab, size=(B, S + 1), p=self._p)
        # paste periodic n-gram motifs so there is learnable structure
        dl = min(self.doc_len, (S + 1) // 2)
        motif = rng.choice(self.vocab, size=dl, p=self._p)
        reps = max(1, (S + 1) // (2 * dl))
        for b in range(B):
            for r in range(reps):
                at = (b * 131 + r * 2 * dl) % max(S + 1 - dl, 1)
                toks[b, at: at + dl] = motif
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class PrefetchLoader:
    """Hedged prefetch: a backup fetch fires if the primary is slow."""

    def __init__(self, stream: TokenStream, deadline_s: float = 5.0,
                 depth: int = 2, delay_fn=None):
        self.stream = stream
        self.deadline = deadline_s
        self.depth = depth
        self.delay_fn = delay_fn          # test hook: simulate stragglers
        self.hedged = 0

    def _fetch(self, step: int, out: "queue.Queue", tag: str):
        try:
            if self.delay_fn is not None:
                time.sleep(self.delay_fn(step, tag))
            out.put((tag, self.stream.batch(step)))
        except Exception as e:   # surface worker failures to the caller
            out.put((tag, e))

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        out: queue.Queue = queue.Queue()
        t1 = threading.Thread(target=self._fetch, args=(step, out, "primary"))
        t1.start()
        try:
            tag, batch = out.get(timeout=self.deadline)
        except queue.Empty:
            self.hedged += 1
            t2 = threading.Thread(target=self._fetch,
                                  args=(step, out, "backup"))
            t2.start()
            tag, batch = out.get()
        if isinstance(batch, Exception):
            raise batch
        return batch
