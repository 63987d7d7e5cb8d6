"""Mesh construction over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
standing for the reference's JAX ``Mesh``: ``("data", "model")``, or
``("pod", "data", "model")`` where ``pod`` composes with ``data`` for
data parallelism.  Each process is one rank on one device; the graph
engine shards partitions over ``model`` and, for the temporally
concurrent patterns, instances over ``data``
(:class:`repro_torch.core.engine.TemporalEngine`).

Every function here is explicit about the process group's backend and
the device: ``nccl`` on ``cuda`` by default, ``gloo`` only when the
caller asks for it (the CPU, or several ranks sharing one card, which
NCCL refuses); ``cuda`` with no card raises.  Nothing picks gloo or the
CPU by itself.

Under ``torchrun`` the process group comes from its environment::

    torchrun --nproc-per-node=2 my_script.py   # my_script calls
    mesh = init_mesh(1, 2)                     # nccl, one GPU a rank
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

#: Below ~64 KiB of actual cut payload the exchange is latency-bound, not
#: bandwidth-bound: the all-reduce's 2(P-1) short hops beat the ring's P-1
#: full-buffer circulations even across pods.
RING_MIN_CUT_BYTES = 1 << 16

#: Above ~1 MiB of cut payload the circulate ring's own (P-1)×NB traffic
#: becomes the bottleneck; the reduce-scatter + all-gather ring
#: ("ring-rs") halves per-device bytes to 2(P-1)/P×NB while keeping every
#: transfer neighbor-to-neighbor.
RING_RS_MIN_CUT_BYTES = 1 << 20


def init_mesh(
    data: int = 1,
    model: int = 1,
    *,
    backend: str = "nccl",
    device="cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: float = 600.0,
):
    """Join (or start) the process group and return a (data, model) mesh
    over it, this rank on ``device``.

    With no ``init_method`` the group comes from torchrun's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); otherwise ``init_method`` (``tcp://host:port`` or
    ``file://path``) with an explicit ``rank`` and ``world_size``.  An
    already initialized group is reused.  The world must hold exactly
    ``data * model`` ranks; rank ``r`` sits at ``(r // model, r %
    model)``.  ``device`` becomes this process's current CUDA device
    before the mesh exists, so that the mesh maps nothing by itself.

    >>> init_mesh(1, 1, backend="nccl", device="cpu")
    Traceback (most recent call last):
        ...
    ValueError: backend 'nccl' needs CUDA devices; pass backend='gloo' to run on the CPU
    """
    dev = _join(backend, device, init_method, rank, world_size, timeout)
    return make_host_mesh(data, model, device=dev)


def _join(backend, device, init_method, rank, world_size, timeout):
    """Validate the backend against the device, make the device current,
    and initialize the process group unless it is; returns the device."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.superstep import resolve_device

    dev = resolve_device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA devices; pass "
                         "backend='gloo' to run on the CPU")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            assert rank is not None and world_size is not None, \
                "an explicit init_method needs rank and world_size"
            kw = dict(init_method=init_method, rank=rank,
                      world_size=world_size)
        dist.init_process_group(backend=backend,
                                timeout=timedelta(seconds=timeout), **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    return dev


def make_host_mesh(data: int = 1, model: int = 1, *, device="cpu"):
    """A (data, model) mesh named ``("data", "model")`` over the
    initialized process group (:func:`init_mesh` starts one), whose size
    must be ``data * model``; ranks row-major."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    ranks = torch.arange(world).reshape(data, model)
    return DeviceMesh(torch.device(device).type, ranks,
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         device="cuda"):
    """The production mesh over torchrun's world: the GPUs of a node
    (``LOCAL_WORLD_SIZE``) on ``model``, the nodes on ``data``; with
    ``multi_pod``, ``("pod", "data", "model")`` with the nodes split
    into two pods (``pod`` composes with ``data``).  Each rank on its
    node-local GPU (``LOCAL_RANK``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    local = int(os.environ["LOCAL_WORLD_SIZE"])
    nodes = int(os.environ["WORLD_SIZE"]) // local
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if multi_pod and nodes % 2:
        raise ValueError(f"two pods need an even node count, got {nodes}")
    dev = _join(backend, dev, None, None, None, 600.0)
    if not multi_pod:
        return make_host_mesh(nodes, local, device=dev)
    ranks = torch.arange(dist.get_world_size()).reshape(2, nodes // 2, local)
    return DeviceMesh(dev.type, ranks,
                      mesh_dim_names=("pod", "data", "model"))


def mesh_dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel dims of ``mesh`` (``pod`` and ``data``)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def recommended_comm(
    mesh, model_axes: Tuple[str, ...] = ("model",),
    *,
    boundary_nnz: Optional[int] = None,
) -> str:
    """Default boundary-exchange backend for a placement
    (``repro_torch.core.comm``), the reference's table:

    * no mesh -> ``"host"`` (mesh-free cluster: combine per-partition
      buffers on the host);
    * ``pod`` among the exchange axes and the cut huge (``4 *
      boundary_nnz >= RING_RS_MIN_CUT_BYTES``) -> ``"ring-rs"``;
    * ``pod`` among the exchange axes and the cut large or unknown ->
      ``"ring"``; a cut below ``RING_MIN_CUT_BYTES`` -> ``"dense"``;
    * otherwise -> ``"dense"``.

    What matters is whether the EXCHANGE axes cross the slow links, not
    whether the mesh has pods: on the production mesh ``pod`` composes
    with ``data`` and the model axis stays within a node.

    >>> recommended_comm(None)
    'host'
    >>> recommended_comm(object(), ("pod", "model"), boundary_nnz=10)
    'dense'
    """
    if mesh is None:
        return "host"
    if "pod" in model_axes:
        if (boundary_nnz is not None
                and boundary_nnz * 4 < RING_MIN_CUT_BYTES):
            return "dense"
        if (boundary_nnz is not None
                and boundary_nnz * 4 >= RING_RS_MIN_CUT_BYTES):
            return "ring-rs"
        return "ring"
    return "dense"
