"""Communication backends for the boundary exchange (counterpart of
``repro.core.comm``).

The paper's iBSP supersteps hinge on ONE collective: merging boundary
vertex state across partitions (§IV-B).  How that merge moves bytes is a
deployment decision, so the engine takes it as a pluggable
:class:`CommBackend`, bound to a placement by :func:`make_comm`:

==================  ========================================================
backend             boundary combine
==================  ========================================================
``DenseAllReduce``  stacked: left fold of the partition axis on the device.
                    On a mesh: the local fold, then one collective over the
                    ``model`` process group — a SUM all-reduce for
                    plus-mul; for min-plus an all-gather of the ranks'
                    partials folded on every rank in rank order (a MIN
                    collective makes no promise about -0 against +0 or
                    about NaN; the semiring's fold does)
``RingExchange``    stacked: the same fold.  On a mesh: P-1 point-to-point
                    hops to the next rank of the model group, folding with
                    the semiring add at every hop — ``circulate`` (backend
                    ``"ring"``) ships the whole (NB,) partial each hop,
                    ``rs_ag`` (backend ``"ring-rs"``) a chunked
                    reduce-scatter then an all-gather, the reference's
                    chunking, ownership ``(i + 1) % n`` and fold order
``HostGather``      the same left fold in numpy on the host: the buffer
                    crosses to host memory and back once per superstep;
                    mesh-free
==================  ========================================================

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``("data", "model")`` or ``("pod", "data", "model")``; see
:mod:`repro_torch.launch.mesh`), standing for the reference's JAX
``Mesh``.  A bound backend's collectives run over the process group of
its ``axis_name`` dims (``mesh.get_group(dim)``; several dims make one
group, ranks row-major in the order given).  Every rank of the group
takes part in every call, in the same order.

The group's backend picks the wire, never a fallback: ``nccl`` moves the
device tensors themselves; ``gloo`` moves host tensors, so a combine of
CUDA tensors copies the local partial to host memory, runs its
collectives or hops and its semiring folds there (the folds are exact,
so the bits do not depend on where they run), and copies the result
back, explicitly; :func:`exchange_stats` counts those copies
(``host_staged_bytes``) beside the operations and the bytes handed to
and taken from the collectives.

Exactness: every stacked backend folds in the fixed association 0..P-1,
so min-plus AND plus-mul are bitwise identical across them.  On a mesh,
min-plus stays bitwise (the semiring add is exact and orders -0 below
+0, so any association gives the same bits; NaN payloads aside), while
plus-mul is reassociated: the all-reduce adds the ranks' partials in its
own order, the ring in each rank's (``circulate``) or each chunk's
(``rs_ag``) ring order — low-order bits differ, as in the reference.

The halt votes: ``any_changed`` ORs the (Q,) lane votes of a superstep
over the model group, ``local_vote`` those of a local sweep (so every
partition shard takes the stacked run's sweep count, whatever its own
partitions say), and ``keep_running`` the loop's "any lane still live"
over ``sync_axes`` (:meth:`CommBackend.bind_sync`).  ``sum_scalar`` is a
SUM over the model group.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.semiring import Semiring

COMM_BACKENDS = ("dense", "ring", "ring-rs", "host")

AxisName = Optional[Union[str, Tuple[str, ...]]]


def _axes(axis_name: AxisName) -> Tuple[str, ...]:
    if axis_name is None:
        return ()
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _stack_fold(buf: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Left-fold the partition axis (-2) with the semiring add, for every
    lane of a leading query axis.  Fixed association 0..P-1 — every
    backend shares it.  Min-plus folds in one reduction: its add is exact
    and orders -0 below +0, so every association gives the same bits."""
    parts = buf.unbind(-2)
    if len(parts) == 1:
        return parts[0]
    if sr.name == "min_plus":
        return sr.add_reduce(buf, -2)
    return functools.reduce(sr.add, parts)


# ---------------------------------------------------------------------------
# Process groups of mesh dims, and the wire
# ---------------------------------------------------------------------------

def mesh_dims(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a DeviceMesh, in the mesh's order; raises
    ``TypeError`` for anything that is not a mesh with named dims."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh with named dims "
            f"(repro_torch.launch.mesh.init_mesh), got {type(mesh).__name__}")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


@dataclass(frozen=True)
class AxisGroup:
    """The process group over some dims of a mesh, from this rank."""

    group: Any  # torch.distributed ProcessGroup
    ranks: Tuple[int, ...]  # global ranks, in group-rank order
    rank: int  # this process's index in ``ranks``
    wire: torch.device  # where tensors cross: the card (nccl), host (gloo)

    @property
    def size(self) -> int:
        return len(self.ranks)


_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, AxisGroup]] = {}


def axis_group(mesh, axes: AxisName) -> AxisGroup:
    """The group over ``axes`` of ``mesh`` that holds this rank: ranks in
    row-major order of ``axes`` as given (one dim: ``mesh.get_group``).
    Several dims make their groups with ``new_subgroups_by_enumeration``,
    which every rank of the world must call in the same order — the first
    ``make_comm`` of those dims does, on every rank.  Cached per mesh."""
    import torch.distributed as dist

    axes = _axes(axes)
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    names = list(mesh_dims(mesh))
    t = mesh.mesh
    order = [i for i, n in enumerate(names) if n not in axes] + [
        names.index(a) for a in axes]
    n = math.prod(int(t.shape[names.index(a)]) for a in axes)
    rows = t.permute(order).reshape(-1, n).tolist()
    me = dist.get_rank()
    row = next(r for r in rows if me in r)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group, _ = dist.new_subgroups_by_enumeration(rows)
    if dist.get_backend(group) == "nccl":
        wire = torch.device("cuda", torch.cuda.current_device())
    else:
        wire = torch.device("cpu")
    g = AxisGroup(group=group, ranks=tuple(row), rank=row.index(me),
                  wire=wire)
    _GROUPS[key] = (mesh, g)
    return g


_STATS = {"ops": 0, "bytes_sent": 0, "bytes_received": 0,
          "host_staged_bytes": 0, "combines": 0, "combine_bytes_sent": 0}


def exchange_stats() -> Dict[str, int]:
    """This process's mesh-exchange counters since the last reset:
    collective and point-to-point operations, bytes handed to them
    (``bytes_sent``) and taken from them (``bytes_received``; an
    all-gather's other ranks' parts, an all-reduce's result), and the
    bytes copied between host memory and the card to put a tensor on the
    wire and back (``host_staged_bytes``: CUDA tensors under gloo, whose
    wire is host memory; the host-side vote flags under nccl); and, of
    those, the boundary combines and the bytes they sent (one combine a
    superstep, a PageRank step or a ``make_spmd_superstep`` call)."""
    return dict(_STATS)


def reset_exchange_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def _to_wire(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    t = t.contiguous()
    if t.device != g.wire:
        _STATS["host_staged_bytes"] += t.numel() * t.element_size()
        t = t.to(g.wire)
    return t


def _from_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        _STATS["host_staged_bytes"] += t.numel() * t.element_size()
        t = t.to(device)
    return t


def all_gather(t: torch.Tensor, g: AxisGroup) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in group-rank order, on
    ``t``'s device."""
    import torch.distributed as dist

    w = _to_wire(t, g)
    parts = [torch.empty_like(w) for _ in range(g.size)]
    dist.all_gather(parts, w, group=g.group)
    nb = w.numel() * w.element_size()
    _STATS["ops"] += 1
    _STATS["bytes_sent"] += nb
    _STATS["bytes_received"] += nb * (g.size - 1)
    return [_from_wire(p, t.device) for p in parts]


def all_reduce(t: torch.Tensor, g: AxisGroup, op: str) -> torch.Tensor:
    """``op`` ("sum" | "max") of every rank's ``t``, on ``t``'s device."""
    import torch.distributed as dist

    w = _to_wire(t, g)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=g.group)
    nb = w.numel() * w.element_size()
    _STATS["ops"] += 1
    _STATS["bytes_sent"] += nb
    _STATS["bytes_received"] += nb
    return _from_wire(w, t.device)


def shift(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """One ring hop: send ``t`` to group rank ``(r + 1) % n`` and return
    what rank ``(r - 1) % n`` sent (a send and a receive, batched)."""
    import torch.distributed as dist

    w = _to_wire(t, g)
    out = torch.empty_like(w)
    n = g.size
    ops = [dist.P2POp(dist.isend, w, g.ranks[(g.rank + 1) % n], g.group),
           dist.P2POp(dist.irecv, out, g.ranks[(g.rank - 1) % n], g.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    nb = w.numel() * w.element_size()
    _STATS["ops"] += 1
    _STATS["bytes_sent"] += nb
    _STATS["bytes_received"] += nb
    return _from_wire(out, t.device)


def _counted_combine(fn):
    """Count a bound backend's boundary combines and the bytes they send
    (``exchange_stats``)."""

    @functools.wraps(fn)
    def combine(self, buf, sr):
        if self.axis_name is None:
            return fn(self, buf, sr)
        sent = _STATS["bytes_sent"]
        out = fn(self, buf, sr)
        _STATS["combines"] += 1
        _STATS["combine_bytes_sent"] += _STATS["bytes_sent"] - sent
        return out

    return combine


def _or_votes(flags: np.ndarray, g: AxisGroup) -> np.ndarray:
    f = torch.as_tensor(np.asarray(flags, bool).astype(np.int32))
    return all_reduce(f, g, "max").cpu().numpy() > 0


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommBackend:
    """Cross-partition combination for one BSP superstep.

    ``combine_boundary`` merges the ([Q,] P_local, NB) boundary buffers
    into the combined ([Q,] NB) buffer every partition consumes, lane by
    lane under the query axis; ``any_changed`` globalizes a superstep's
    vote-to-halt flags ((Q,) bool, one per lane), ``local_vote`` a local
    sweep's, ``keep_running`` the loop's "any lane live"; ``sum_scalar``
    globalizes scalar reductions (PageRank's L1 delta).  Unbound
    (``axis_name=None``: stacked, one process holds every partition) the
    last four are the identity.  ``mesh`` is the DeviceMesh a bound
    backend's groups come from (:func:`make_comm` sets it)."""

    axis_name: AxisName = None
    name: str = "abstract"
    mesh: Any = field(default=None, compare=False, repr=False)

    def _group(self) -> AxisGroup:
        return axis_group(self.mesh, self.axis_name)

    def combine_boundary(self, buf: torch.Tensor, sr: Semiring) -> torch.Tensor:
        raise NotImplementedError

    def any_changed(self, flags: np.ndarray) -> np.ndarray:
        if self.axis_name is None:
            return flags
        return _or_votes(flags, self._group())

    def local_vote(self, flags: np.ndarray) -> np.ndarray:
        if self.axis_name is None:
            return flags
        return _or_votes(flags, self._group())

    def keep_running(self, running: bool) -> bool:
        return running

    def sum_scalar(self, x):
        if self.axis_name is None:
            return x
        return all_reduce(torch.as_tensor(x), self._group(), "sum")

    def bind_sync(self, axes: Tuple[str, ...]) -> "CommBackend":
        """Bind extra mesh dims the loop's continuation syncs over.

        The engine calls this when instances are sharded over ``data``
        (concurrent data-dependent superstep loops).  The reference's ring
        needs it: XLA schedules one collective-permute across all devices.
        Torch's collectives are group-scoped, so nothing deadlocks without
        it; the ring keeps the reference's contract all the same
        (``keep_running``), and its extra iterations run nothing but that
        vote, so every count equals the stacked run's.  Group-scoped
        backends ignore this."""
        return self


@dataclass(frozen=True)
class DenseAllReduce(CommBackend):
    """The default backend: the local fold, then (on a mesh) one
    collective over the model group (module docstring).

    >>> import torch
    >>> from repro_torch.core.semiring import MIN_PLUS
    >>> buf = torch.tensor([[0., 7., float("inf")],
    ...                     [float("inf"), 2., 5.]])  # 2 parts, 3 slots
    >>> DenseAllReduce().combine_boundary(buf, MIN_PLUS)
    tensor([0., 2., 5.])
    """

    name: str = "dense"

    @_counted_combine
    def combine_boundary(self, buf, sr):
        out = _stack_fold(buf, sr)
        if self.axis_name is None:
            return out
        g = self._group()
        w = _to_wire(out, g)  # the combine runs on the wire's device
        if sr.name == "plus_mul":
            w = all_reduce(w, g, "sum")
        else:
            w = _stack_fold(torch.stack(all_gather(w, g), dim=-2), sr)
        return _from_wire(w, out.device)


@dataclass(frozen=True)
class RingExchange(CommBackend):
    """Point-to-point ring over the model group (module docstring);
    stacked, it degenerates to the dense fold.  ``axis_sizes`` pins the
    ring length per dim (``make_comm`` derives it from the mesh); a dim
    of size 1 has no hop.

    >>> import torch
    >>> from repro_torch.core.semiring import MIN_PLUS
    >>> buf = torch.tensor([[0., 7., float("inf")],
    ...                     [float("inf"), 2., 5.]])
    >>> RingExchange(name="ring-rs", variant="rs_ag").combine_boundary(
    ...     buf, MIN_PLUS)
    tensor([0., 2., 5.])
    """

    name: str = "ring"
    axis_sizes: Tuple[int, ...] = ()
    variant: str = "circulate"  # "circulate" | "rs_ag" (ring-rs)
    # extra dims the loop's continuation syncs over (bind_sync)
    sync_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        assert len(_axes(self.axis_name)) == len(self.axis_sizes), \
            "RingExchange needs one static axis size per mesh axis " \
            "(use make_comm to derive them from the mesh)"
        assert self.variant in ("circulate", "rs_ag"), \
            f"unknown ring variant {self.variant!r}"

    def bind_sync(self, axes: Tuple[str, ...]) -> "RingExchange":
        return dataclasses.replace(self, sync_axes=tuple(axes))

    def keep_running(self, running: bool) -> bool:
        for ax in self.sync_axes:
            running = bool(_or_votes(np.array([running]),
                                     axis_group(self.mesh, ax))[0])
        return running

    def _ring(self, x: torch.Tensor, sr: Semiring, g: AxisGroup):
        """Circulate: n - 1 hops of the whole partial, folded as it
        comes (``x = add(x, recv)``)."""
        send = x
        for _ in range(g.size - 1):
            send = shift(send, g)
            x = sr.add(x, send)
        return x

    def _ring_rs_ag(self, x: torch.Tensor, sr: Semiring, g: AxisGroup):
        """Chunked reduce-scatter + all-gather along the last dim: the
        buffer is padded with the semiring zero to a multiple of ``n`` and
        cut into ``n`` chunks; on hop ``s`` a rank forwards its running
        partial and folds the received one with its own copy of chunk
        ``(r - 1 - s) % n`` (``add(recv, own)``), so after ``n - 1`` hops
        rank ``r`` owns chunk ``(r + 1) % n`` folded in rank order
        ``c, c+1, ..``; then the owned chunks circulate ``n - 1`` more
        hops into place."""
        n, r = g.size, g.rank
        nb = x.shape[-1]
        pad = (-nb) % n
        if pad:
            x = torch.cat([x, sr.full(x.shape[:-1] + (pad,), x.dtype,
                                      x.device)], dim=-1)
        chunks = x.reshape(*x.shape[:-1], n, -1)
        send = chunks[..., r, :]
        for s in range(n - 1):
            send = sr.add(shift(send, g), chunks[..., (r - 1 - s) % n, :])
        out = chunks.clone()
        out[..., (r + 1) % n, :] = send
        for s in range(n - 1):
            send = shift(send, g)
            out[..., (r - s) % n, :] = send
        return out.reshape(*x.shape[:-1], -1)[..., :nb]

    @_counted_combine
    def combine_boundary(self, buf, sr):
        out = _stack_fold(buf, sr)
        x = out
        for ax, n in zip(_axes(self.axis_name), self.axis_sizes):
            if n == 1:
                continue
            g = axis_group(self.mesh, ax)
            x = _to_wire(x, g)  # hops and folds on the wire's device
            x = (self._ring_rs_ag if self.variant == "rs_ag"
                 else self._ring)(x, sr, g)
        return _from_wire(x, out.device)


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


_MESH_FREE = ("HostGather is mesh-free (it folds all partition buffers in "
              "one host process); use 'dense' or 'ring' on a mesh")


def make_comm(
    backend: Union[str, CommBackend] = "dense",
    *,
    mesh=None,
    model_axes: Tuple[str, ...] = ("model",),
) -> CommBackend:
    """Bind a backend name (or pass an instance through) to a placement.

    ``mesh=None`` binds the stacked form (``axis_name=None``); with a mesh
    the backend combines over ``model_axes`` (``RingExchange`` also takes
    the ring lengths from the mesh).  A prebuilt instance is validated
    against the placement as in the reference — an unbound backend on a
    mesh would fold only its own shard — and, bound to the right dims
    but to no mesh yet, gets this one (a copy); one bound to another mesh
    is refused.

    >>> make_comm("dense").name
    'dense'
    >>> make_comm("ring").axis_name is None   # stacked: fold, no ring
    True
    >>> make_comm("ring-rs").variant
    'rs_ag'
    >>> make_comm("nope")
    Traceback (most recent call last):
        ...
    ValueError: unknown comm backend 'nope'; pick from ('dense', 'ring', 'ring-rs', 'host')
    """
    axes = tuple(model_axes)
    dims = None if mesh is None else mesh_dims(mesh)
    if isinstance(backend, CommBackend):
        if mesh is None:
            if backend.axis_name is not None:
                raise ValueError(
                    f"comm backend {backend.name!r} is bound to mesh axes "
                    f"{backend.axis_name!r} but no mesh was given")
            return backend
        if isinstance(backend, HostGather):
            raise ValueError(_MESH_FREE)
        bound = _axes(backend.axis_name)
        if not bound:
            raise ValueError(
                f"comm backend {backend.name!r} is unbound (axis_name=None) "
                f"but the engine runs on a mesh over {axes!r}: it would "
                f"combine only the local shard — pass the backend NAME to "
                f"bind it, or bind axis_name yourself")
        missing = [a for a in bound if a not in dims]
        if missing:
            raise ValueError(
                f"comm backend {backend.name!r} is bound to {bound!r} but "
                f"the mesh only has axes {tuple(dims)!r}")
        if isinstance(backend, RingExchange):
            want = tuple(dims[a] for a in bound)
            if backend.axis_sizes != want:
                raise ValueError(
                    f"RingExchange axis_sizes {backend.axis_sizes!r} do not "
                    f"match the mesh shape {want!r} over {bound!r}")
        if backend.mesh is mesh:
            return backend
        if backend.mesh is not None:
            raise ValueError(
                f"comm backend {backend.name!r} is bound to another mesh")
        return dataclasses.replace(backend, mesh=mesh)
    if mesh is not None:
        missing = [a for a in axes if a not in dims]
        if missing:
            raise ValueError(
                f"model_axes {axes!r} are not all dims of the mesh "
                f"{tuple(dims)!r}")
    axis_name = None if mesh is None else axes
    if backend == "dense":
        return DenseAllReduce(axis_name=axis_name, mesh=mesh)
    if backend in ("ring", "ring-rs"):
        variant = "rs_ag" if backend == "ring-rs" else "circulate"
        sizes = () if mesh is None else tuple(dims[a] for a in axes)
        return RingExchange(name=backend, axis_name=axis_name,
                            axis_sizes=sizes, variant=variant, mesh=mesh)
    if backend == "host":
        if mesh is not None:
            raise ValueError(_MESH_FREE)
        return HostGather()
    raise ValueError(
        f"unknown comm backend {backend!r}; pick from {COMM_BACKENDS}")
