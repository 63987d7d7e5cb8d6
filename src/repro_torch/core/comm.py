"""Communication backends for the boundary exchange, stacked placement.

Counterpart of ``repro.core.comm`` for ``mesh=None``: all partitions live
on one device's leading axis, so the boundary combine is a fold of the
(P, num_boundary) publish buffer.

==================  ========================================================
backend             boundary combine (stacked)
==================  ========================================================
``DenseAllReduce``  left fold of the partition axis on the device
``RingExchange``    the same fold (a ring only differs across devices)
``HostGather``      the same left fold in numpy on the host: the buffer
                    crosses to host memory and back once per superstep
==================  ========================================================

Every backend folds in the fixed association 0..P-1, so min-plus AND
plus-mul results are bitwise identical across backends.  Mesh and NCCL
backends are not ported yet (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from repro_torch.core.semiring import Semiring

COMM_BACKENDS = ("dense", "ring", "ring-rs", "host")


def _stack_fold(buf: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Left-fold the partition axis (-2) with the semiring add, for every
    lane of a leading query axis.  Fixed association 0..P-1 — every
    backend shares it."""
    parts = buf.unbind(-2)
    if len(parts) == 1:
        return parts[0]
    return functools.reduce(sr.add, parts)


@dataclass(frozen=True)
class CommBackend:
    """Cross-partition combination for one BSP superstep.

    ``combine_boundary`` merges the ([Q,] P, NB) boundary buffers into the
    combined ([Q,] NB) buffer every partition consumes, lane by lane under
    the query axis; ``any_changed`` globalizes the vote-to-halt flags, one
    per lane ((Q,) bool); ``sum_scalar`` globalizes scalar reductions
    (PageRank's L1 delta).  Stacked, the last two are the identity: one
    process holds every partition.
    """

    name: str = "abstract"

    def combine_boundary(self, buf: torch.Tensor, sr: Semiring) -> torch.Tensor:
        raise NotImplementedError

    def any_changed(self, flags: np.ndarray) -> np.ndarray:
        return flags

    def sum_scalar(self, x):
        return x


@dataclass(frozen=True)
class DenseAllReduce(CommBackend):
    """The default backend: fold the partition axis on the device.

    >>> import torch
    >>> from repro_torch.core.semiring import MIN_PLUS
    >>> buf = torch.tensor([[0., 7., float("inf")],
    ...                     [float("inf"), 2., 5.]])  # 2 parts, 3 slots
    >>> DenseAllReduce().combine_boundary(buf, MIN_PLUS)
    tensor([0., 2., 5.])
    """

    name: str = "dense"

    def combine_boundary(self, buf, sr):
        return _stack_fold(buf, sr)


@dataclass(frozen=True)
class RingExchange(CommBackend):
    """Ring exchange; stacked, it degenerates to the dense fold."""

    name: str = "ring"
    variant: str = "circulate"  # "circulate" | "rs_ag" (ring-rs)

    def combine_boundary(self, buf, sr):
        return _stack_fold(buf, sr)


def _host_fold_min(buf: np.ndarray) -> np.ndarray:
    out = buf[..., 0, :]
    for i in range(1, buf.shape[-2]):
        out = np.minimum(out, buf[..., i, :])
    return out


def _host_fold_sum(buf: np.ndarray) -> np.ndarray:
    out = buf[..., 0, :]
    for i in range(1, buf.shape[-2]):
        out = out + buf[..., i, :]
    return out


@dataclass(frozen=True)
class HostGather(CommBackend):
    """Mesh-free backend: combine boundary buffers on the host.

    The ([Q,] P, NB) publish buffer crosses to host memory once per
    superstep, is folded there over its partition axis with a numpy left
    fold in the same 0..P-1 association as the device fold
    (bitwise-identical results), and the combined ([Q,] NB) buffer returns
    to the device — the paper's §V commodity-cluster
    exchange shape, where the fold site is where a network gather slots in.

    >>> import torch
    >>> from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    >>> buf = torch.tensor([[0., 7., float("inf")],
    ...                     [float("inf"), 2., 5.]])
    >>> HostGather().combine_boundary(buf, MIN_PLUS)
    tensor([0., 2., 5.])
    >>> HostGather().combine_boundary(torch.tensor([[1., 2.], [3., 4.]]),
    ...                               PLUS_MUL)
    tensor([4., 6.])
    >>> HostGather().combine_boundary(torch.stack([buf, buf + 1]), MIN_PLUS)
    tensor([[0., 2., 5.],
            [1., 3., 6.]])
    """

    name: str = "host"

    def combine_boundary(self, buf, sr):
        fold = _host_fold_sum if sr.name == "plus_mul" else _host_fold_min
        out = fold(buf.detach().cpu().numpy())
        return torch.from_numpy(np.ascontiguousarray(out)).to(buf.device)


def make_comm(
    backend: Union[str, CommBackend] = "dense", *, mesh=None,
) -> CommBackend:
    """Bind a backend name (or pass an instance through), stacked only.

    >>> make_comm("dense").name
    'dense'
    >>> make_comm("ring-rs").variant
    'rs_ag'
    >>> make_comm("nope")
    Traceback (most recent call last):
        ...
    ValueError: unknown comm backend 'nope'; pick from ('dense', 'ring', 'ring-rs', 'host')
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh placement is not ported yet (ROADMAP queue 1, item 6: "
            "multi-GPU placement over torch.distributed)")
    if isinstance(backend, CommBackend):
        return backend
    if backend == "dense":
        return DenseAllReduce()
    if backend in ("ring", "ring-rs"):
        return RingExchange(
            name=backend, variant="rs_ag" if backend == "ring-rs"
            else "circulate")
    if backend == "host":
        return HostGather()
    raise ValueError(
        f"unknown comm backend {backend!r}; pick from {COMM_BACKENDS}")
