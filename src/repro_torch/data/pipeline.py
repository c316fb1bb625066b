"""Deterministic, host-sharded token pipeline (counterpart of
``repro.data.pipeline``, a copy of it: the module is numpy only).

Two sources behind one interface:
  * SyntheticLM — seed-derived token streams (markov-ish mixture so loss can
    actually decrease); batch content is a pure function of (seed, step,
    host), so restarts resume bit-identically without data-state checkpoints.
  * MemmapTokens — flat binary token file, deterministic shuffled windows.

Each host materializes only its slice of the global batch
([process_index * per_host, ...)), and a background thread prefetches.
Batches are numpy ``int32`` arrays, equal bit for bit to the JAX package's
at the same (seed, step, host); the caller moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM batches with learnable structure."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab, self.seq = vocab, seq_len
        self.batch = global_batch // n_hosts
        self.seed, self.host = seed, host_id

    def _gen(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        B, S, V = self.batch, self.seq + 1, self.vocab
        # mixture of a linear-congruential stream (predictable) and noise
        start = rng.integers(0, V, (B, 1))
        ramp = (start + 7 * np.arange(S)[None, :]) % V
        noise = rng.integers(0, V, (B, S))
        take_noise = rng.random((B, S)) < 0.15
        return np.where(take_noise, noise, ramp).astype(np.int32)

    def __call__(self, step: int) -> dict:
        toks = self._gen(step)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class MemmapTokens:
    """Flat token file -> deterministic shuffled (seq+1)-windows."""

    def __init__(self, path: str, seq_len: int, global_batch: int, *,
                 dtype=np.uint16, seed: int = 0, n_hosts: int = 1,
                 host_id: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq = seq_len
        self.batch = global_batch // n_hosts
        self.seed, self.host, self.n_hosts = seed, host_id, n_hosts
        self.n_windows = (len(self.data) - 1) // (seq_len + 1)
        if self.n_windows < self.batch:
            raise ValueError(f"dataset too small: {self.n_windows} windows "
                             f"of {seq_len + 1} tokens for a batch of "
                             f"{self.batch}")

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # one global permutation draw per step; each host takes its slice
        idx = rng.choice(self.n_windows, self.batch * self.n_hosts,
                         replace=False)
        idx = idx[self.host * self.batch:(self.host + 1) * self.batch]
        W = self.seq + 1
        out = np.stack([np.asarray(self.data[i * W:(i + 1) * W])
                        for i in idx]).astype(np.int32)
        return {"tokens": out[:, :-1], "targets": out[:, 1:]}


def make_source(kind: str, **kw):
    return {"synthetic": SyntheticLM, "memmap": MemmapTokens}[kind](**kw)


def prefetched(source, start_step: int = 0, depth: int = 2) -> Iterator[dict]:
    """Background-thread prefetch of source(step) batches."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(source(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
