"""Deterministic synthetic token pipeline with background prefetch.

PyTorch counterpart of ``repro/data/pipeline.py``.  Batches are
generated per (seed, step) with numpy, bit for bit the reference's
(cheap, reproducible across restarts: checkpoint/resume replays the
exact stream), and come as host tensors: the trainer moves them to
its device.  Over a mesh the sharded step splits each batch's rows
itself (sharding/plans.batch_placement); the reference's per-host
shards of a multi-host pipeline are not ported (one host).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class SyntheticLMData:
    """Causal-LM batches: tokens[t+1] = labels[t], Zipf-ish token dist."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, extra: Optional[Dict[str, Any]] = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.extra = extra or {}

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # Zipf-like marginal: realistic token frequency skew
        u = rng.random((self.batch, self.seq + 1))
        toks = np.minimum((self.vocab * u ** 3).astype(np.int32),
                          self.vocab - 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for name, (shape, dtype) in self.extra.items():
            out[name] = rng.standard_normal((self.batch,) + shape
                                            ).astype(dtype)
        return out

    def batches(self, start_step: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in self._host_batch(step).items()}
            step += 1


class Prefetcher:
    """Background-thread prefetch of `depth` batches."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
