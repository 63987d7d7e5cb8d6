"""Deterministic, seekable data pipeline (the port's own copy of
``repro.train.data``, which is numpy only).

``SyntheticLMDataset`` generates token batches from a counter-based RNG
(Philox): batch ``i`` is a pure function of (seed, i), so resuming training
at step N reproduces the exact stream with O(1) seek — the property the
checkpoint/restart contract needs.  ``PackedShardDataset`` reads GoFS-style
packed token shards from disk with a prefetch thread (double buffering, the
disk analogue of the paper's slice cache).

``batch_at`` gives the reference's batches bit for bit (the same Philox
key and counter, the same label rule), and either package's
``PackedShardDataset`` reads the shards the other's
``write_packed_shards`` wrote.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        # markov-ish stream so the loss is learnable, not pure noise
        base = rng.integers(
            0, self.vocab_size, size=(self.global_batch, self.seq_len + 1),
            dtype=np.int32,
        )
        tokens = base[:, :-1]
        labels = base[:, 1:].copy()
        # make ~50% of next-tokens predictable: label = (token * 7 + 1) % V
        mask = rng.random((self.global_batch, self.seq_len)) < 0.5
        labels[mask] = (tokens[mask].astype(np.int64) * 7 + 1).astype(np.int32) % self.vocab_size
        return {"tokens": tokens, "labels": labels}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        i = step
        while True:
            yield self.batch_at(i)
            i += 1


def write_packed_shards(
    out_dir: str, tokens: np.ndarray, *, shard_tokens: int = 1 << 20
) -> None:
    """Pack a flat token stream into GoFS-like shard slices + manifest."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(tokens)
    shards = []
    for i, start in enumerate(range(0, n, shard_tokens)):
        fn = f"shard_{i:05d}.npy"
        np.save(os.path.join(out_dir, fn), tokens[start : start + shard_tokens])
        shards.append({"file": fn, "start": start, "len": min(shard_tokens, n - start)})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"total_tokens": n, "shards": shards}, f)


class PackedShardDataset:
    """Sequential reader over packed shards with background prefetch."""

    def __init__(self, shard_dir: str, seq_len: int, global_batch: int,
                 prefetch: int = 2):
        with open(os.path.join(shard_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.shard_dir = shard_dir
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.prefetch = prefetch
        self.tokens_per_batch = seq_len * global_batch

    def _read_span(self, start: int, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        filled = 0
        for sh in self.manifest["shards"]:
            s0, s1 = sh["start"], sh["start"] + sh["len"]
            lo = max(start, s0)
            hi = min(start + length, s1)
            if lo < hi:
                arr = np.load(os.path.join(self.shard_dir, sh["file"]),
                              mmap_mode="r")
                out[lo - start : hi - start] = arr[lo - s0 : hi - s0]
                filled += hi - lo
        if filled != length:
            raise ValueError("span out of range")
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        span = self.tokens_per_batch + self.global_batch  # +1 label per row
        start = (step * span) % max(self.manifest["total_tokens"] - span, 1)
        flat = self._read_span(start, span)
        rows = flat[: self.global_batch * (self.seq_len + 1)].reshape(
            self.global_batch, self.seq_len + 1
        )
        return {"tokens": rows[:, :-1].copy(), "labels": rows[:, 1:].copy()}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            i = step
            while not stop.is_set():
                q.put(self.batch_at(i))
                i += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
