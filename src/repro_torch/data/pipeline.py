"""Deterministic synthetic token pipeline with host sharding + prefetch.

The JAX package's ``repro.data.pipeline`` in numpy alone.  Each global step
has a unique seed derived from (base_seed, step, host), so a
restarted-from-checkpoint run replays the exact same batches, and the same
(seed, step, host) gives the JAX pipeline's batch byte for byte.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        if shape.global_batch % n_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"divide over {n_hosts} hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def batch_for_step(self, step: int) -> dict:
        """Pure function of (seed, step, host): restart-safe."""
        B = self.shape.global_batch // self.n_hosts
        S = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        if self.cfg.input_kind == "embeds":
            tokens = rng.standard_normal((B, S, self.cfg.d_model),
                                         dtype=np.float32)
        else:
            tokens = rng.integers(0, self.cfg.vocab_size, (B, S),
                                  dtype=np.int32)
        labels = rng.integers(0, self.cfg.vocab_size, (B, S), dtype=np.int32)
        return {"tokens": tokens, "labels": labels}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_for_step(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step
        return batch

    def close(self):
        """Stop the producer and wait for it (it checks every 0.1 s)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
