"""Slice files — GoFS's unit of disk storage and access (paper §V-A).

A slice is one file holding a serialized block of logically-related data
(template topology, one attribute x one bin x one time pack, or metadata).
Bulk-reading a slice amortizes disk latency over a chunk of co-accessed
bytes; slice sizes span O(MB) by construction of the packing knobs.

Format: raw ``numpy.save``/``numpy.load`` for arrays (zero-copy mmap-able),
JSON for metadata slices.  Read accounting (count, bytes, wall time) feeds
the Fig. 6/8 benchmarks.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class ReadStats:
    slices_read: int = 0
    bytes_read: int = 0
    read_seconds: float = 0.0

    def reset(self) -> None:
        self.slices_read = 0
        self.bytes_read = 0
        self.read_seconds = 0.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "slices_read": self.slices_read,
            "bytes_read": self.bytes_read,
            "read_seconds": self.read_seconds,
        }


def write_array_slice(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """Write a multi-array slice (npz, uncompressed).  Returns bytes.

    The write is atomic (temp file + ``os.replace``): a concurrent reader
    sees either the previous slice or the new one, never a torn file.
    Append-time pack rewrites (``append_instances``) rely on this.
    """
    os.makedirs(os.path.dirname(path), exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)
    return os.path.getsize(final)


def read_array_slice(path: str, stats: Optional[ReadStats] = None) -> Dict[str, np.ndarray]:
    """Read a full slice from disk (bulk read — the GoFS access grain).

    A corrupt file (truncated zip, bad compression stream — e.g. a pack
    damaged after an append) raises ``ValueError`` rather than leaking
    format-library exceptions, so every fallback site that already
    handles unreadable slices handles damaged ones too."""
    import zipfile
    import zlib

    p = path if path.endswith(".npz") else path + ".npz"
    t0 = time.perf_counter()
    try:
        with np.load(p) as z:
            out = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, zlib.error) as e:
        raise ValueError(f"corrupt slice {p}: {e}") from e
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.slices_read += 1
        stats.bytes_read += os.path.getsize(p)
        stats.read_seconds += dt
    return out


def write_json_slice(path: str, obj: Any) -> None:
    """Atomic JSON metadata write (temp file + ``os.replace``).

    ``collection.json`` is the collection's version manifest: an append
    commits by replacing it *after* all data slices are durable, so a
    reader always observes a complete collection at some version."""
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def default(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=default)
    os.replace(tmp, path)


def read_json_slice(path: str, stats: Optional[ReadStats] = None) -> Any:
    t0 = time.perf_counter()
    with open(path) as f:
        out = json.load(f)
    if stats is not None:
        stats.slices_read += 1
        stats.bytes_read += os.path.getsize(path)
        stats.read_seconds += time.perf_counter() - t0
    return out
