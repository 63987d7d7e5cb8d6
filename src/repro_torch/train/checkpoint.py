"""GoFS-style atomic checkpoints (counterpart of
``repro.train.checkpoint``).

Each leaf of a state dict is a *slice file* (``.npy``), a *manifest*
(``manifest.json``) indexes the leaves' names, shapes and dtypes with the
step, and commits are atomic: write a temporary directory, fsync the
manifest, rename.  The layout, the leaf naming (nested keys joined by
``/``, stored as ``__``) and the manifest are the reference's, so either
package reads the other's snapshots.

Fault-tolerance contract:
  * a crash mid-save never corrupts the previous checkpoint (atomic
    rename);
  * ``list_steps`` and ``restore`` skip incomplete step directories (no
    manifest = not committed; ``.tmp`` = never renamed);
  * retention keeps the newest K checkpoints;
  * ``AsyncCheckpointer.save`` snapshots to host memory synchronously and
    writes on a background thread, so the train loop is not I/O-bound.

State dicts hold numpy arrays, tensors (moved to the host) or scalars,
nested in dicts, lists and tuples.

>>> import numpy as np, tempfile
>>> d = tempfile.mkdtemp()
>>> _ = save(d, 3, {"w": {"a": np.arange(4.0)}, "n": np.int32(7)})
>>> list_steps(d)
[3]
>>> state, step = restore(d, {"w": {"a": np.zeros(4)}, "n": np.int32(0)})
>>> step, state["w"]["a"].tolist(), int(state["n"])
(3, [0.0, 1.0, 2.0, 3.0], 7)
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST = "manifest.json"


def _flatten_with_paths(tree: Any, path: Tuple[str, ...] = ()
                        ) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _to_host(leaf: Any) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a tensor, wherever it lives
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(
    ckpt_dir: str,
    step: int,
    state: Dict[str, Any],
    *,
    keep: int = 3,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Synchronous atomic save of ``state`` as ``step_<step>``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra_meta or {}}
    for name, leaf in _flatten_with_paths(state):
        arr = _to_host(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    """Committed steps, ascending (torn and uncommitted directories are
    invisible)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
                out.append(int(d[len("step_"):]))
    return sorted(out)


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _bfloat16_widened(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A leaf the manifest calls ``bfloat16`` (the reference's moments
    under ``state_dtype="bfloat16"``, saved from an ``ml_dtypes`` array)
    as float32, exactly, from its bits: numpy alone loads such a file as
    raw 2-byte records, which no cast reads.  Other leaves as they are."""
    if dtype == "bfloat16" and arr.dtype.itemsize == 2 and \
            arr.dtype.kind == "V":
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def restore(
    ckpt_dir: str,
    like: Dict[str, Any],
    step: Optional[int] = None,
) -> Tuple[Dict[str, Any], int]:
    """Restore into the structure of ``like`` (shapes validated, dtypes
    cast to ``like``'s): numpy arrays where ``like`` holds arrays or
    scalars, host tensors where it holds tensors.  ``step`` defaults to
    the newest committed one."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    named = list(_flatten_with_paths(like))
    missing = [n for n, _ in named if n not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    arrays = []
    for name, leaf in named:
        meta = manifest["leaves"][name]
        arr = _bfloat16_widened(np.load(os.path.join(d, meta["file"])),
                                meta["dtype"])
        want_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{name}: shape {arr.shape} != expected {want_shape}")
        if hasattr(leaf, "detach"):
            import torch

            arrays.append(torch.from_numpy(arr).to(leaf.dtype))
        else:
            arrays.append(arr.astype(np.asarray(leaf).dtype, copy=False))
    return _unflatten(like, iter(arrays)), step


def _snapshot(tree: Any) -> Any:
    """``tree`` with every leaf a host numpy array; tensors are copied (a
    CPU tensor's memory would otherwise be shared with the array, and the
    train step updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if tree is None:
        return None
    if hasattr(tree, "detach") and tree.device.type == "cpu":
        return tree.detach().numpy().copy()
    return _to_host(tree)


class AsyncCheckpointer:
    """Snapshot-on-host, write-in-background checkpointer.  ``save`` waits
    for the previous write, snapshots ``state`` to host numpy and starts a
    thread that writes it with :func:`save` (atomic, with retention
    ``keep``); ``wait`` joins it and re-raises the writer's error."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, state: Dict[str, Any], **kw) -> None:
        self.wait()
        snapshot = _snapshot(state)

        def work():
            try:
                save(self.ckpt_dir, step, snapshot, keep=self.keep, **kw)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
