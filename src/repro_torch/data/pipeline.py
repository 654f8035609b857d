"""Deterministic, resumable token pipeline (synthetic corpus).

A copy of the JAX package's ``data/pipeline.py``: the batches are numpy
arrays drawn from the same ``SeedSequence([seed, step, host_id])``, so both
packages train on the same tokens bit for bit; the train step moves them to
its device.

Production properties this models:
  * **Deterministic skip-ahead**: batch at step s is a pure function of
    (seed, s) — resuming from a checkpoint at step s replays nothing.
  * **Per-host sharding**: each host draws only its slice of the global batch
    (``host_id``/``num_hosts``), so a straggler host only delays its own feed.
  * **Prefetch**: a background thread keeps a small queue of ready batches.

The synthetic corpus is a mixture of a Zipf unigram stream and short repeated
motifs — enough signal that a ~10M-param model visibly learns (loss drops)
when trained (``python -m repro_torch.launch.train``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.sanitizer.threads import san_thread

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2):
        assert global_batch % num_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = None  # the producer (san_thread), once started
        self._stop = threading.Event()

    # -- deterministic batch synthesis ---------------------------------------

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # Zipf-ish unigrams
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks ** 1.1
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s), p=probs)
        # Inject repeated motifs (learnable bigram structure).
        motif = rng.integers(0, v, size=(8,))
        for i in range(b):
            pos = rng.integers(0, max(s - 16, 1))
            reps = (s - pos) // 8
            if reps > 0:
                toks[i, pos:pos + 8 * min(reps, 2)] = np.tile(
                    motif, min(reps, 2))
        return {"tokens": toks.astype(np.int32)}

    # -- prefetching iterator -------------------------------------------------

    def start(self, start_step: int) -> Iterator[dict[str, np.ndarray]]:
        self._stop.clear()

        def producer():
            s = start_step
            while not self._stop.is_set():
                try:
                    self._queue.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._thread = san_thread(producer, daemon=True)
        self._thread.start()

        def consumer():
            while True:
                yield self._queue.get()

        return consumer()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
