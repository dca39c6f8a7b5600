"""Deterministic synthetic token pipeline: sharded, resumable, prefetched
(a copy of ``repro.data.pipeline``, which the port may not import; numpy and
threads only, held equal to the original by tests/test_torch_train.py).

Production shape without external deps: tokens are a seeded hash of
(stream position), so any worker can materialize any slice of the global
stream independently — exactly what elastic restarts need (state = a single
int64 step counter; restoring to a different DP degree re-slices the same
stream).  A background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def _hash_tokens(lo: np.ndarray, vocab: int, seed: int) -> np.ndarray:
    """splitmix64 over absolute positions -> [0, vocab)."""
    mix = (seed * 0x9E3779B97F4A7C15) % (1 << 64)
    with np.errstate(over="ignore"):
        z = (lo.astype(np.uint64) + np.uint64(mix)) * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return (z % np.uint64(vocab)).astype(np.int32)


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    prefetch: int = 2


class TokenPipeline:
    """Iterator of {"tokens", "labels"} batches for this DP shard."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        assert cfg.global_batch % cfg.dp_size == 0
        self.cfg = cfg
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ---- deterministic materialization -------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        local_batch = cfg.global_batch // cfg.dp_size
        # absolute sequence index of each row in the global stream
        row0 = step * cfg.global_batch + self.cfg.dp_rank * local_batch
        rows = row0 + np.arange(local_batch)
        pos = rows[:, None] * (cfg.seq_len + 1) + np.arange(cfg.seq_len + 1)[None, :]
        toks = _hash_tokens(pos.reshape(-1), cfg.vocab_size, cfg.seed).reshape(
            local_batch, cfg.seq_len + 1
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    # ---- background prefetch ------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_at(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._q.get()
        self.step += 1
        return b

    def state(self) -> int:
        """Checkpointable state: the global step counter."""
        return self.step

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
