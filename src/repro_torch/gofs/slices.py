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
from typing import Any, Dict, List, Optional, Union

import numpy as np
from numpy.lib import format as npformat


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


def write_array_slice(
    path: str, arrays: Dict[str, Union[np.ndarray, List[np.ndarray]]],
) -> int:
    """Write a multi-array slice (npz, uncompressed).  Returns bytes.

    A value given as a list of arrays is written as their concatenation
    on the leading axis, part by part, without building it in memory
    (an appended payload pool: the recorded payloads, then the new ones).

    The write is atomic (temp file + ``os.replace``): a concurrent reader
    sees either the previous slice or the new one, never a torn file.
    Append-time pack rewrites (``append_instances``) rely on this.
    """
    import zipfile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(val, list):
                    _write_parts(fid, val)
                else:
                    npformat.write_array(fid, np.asanyarray(val))
    os.replace(tmp, final)
    return os.path.getsize(final)


def _write_parts(fid, parts: List[np.ndarray]) -> None:
    """One ``.npy`` member holding ``np.concatenate(parts)``, streamed."""
    parts = [np.ascontiguousarray(p) for p in parts]
    dtype, tail = parts[0].dtype, parts[0].shape[1:]
    assert all(p.dtype == dtype and p.shape[1:] == tail for p in parts)
    header = {"descr": npformat.dtype_to_descr(dtype),
              "fortran_order": False,
              "shape": (sum(len(p) for p in parts),) + tail}
    try:
        npformat.write_array_header_1_0(fid, header)
    except ValueError:  # a header too long for format 1.0
        npformat.write_array_header_2_0(fid, header)
    step = 1 << 26
    for p in parts:
        flat = p.reshape(-1).view(np.uint8)
        for i in range(0, flat.size, step):
            fid.write(flat[i:i + step])


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
