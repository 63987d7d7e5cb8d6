"""Temporal parallelism on the mesh (counterpart of ``repro.core.temporal``;
paper §IV-B orchestration).

The *independent* and *eventually dependent* patterns expose concurrency
ACROSS graph instances; on a mesh (a ``torch.distributed`` DeviceMesh,
:mod:`repro_torch.launch.mesh`) instances map onto the ``data`` dim while
graph partitions stay on ``model`` — both forms of the paper's
parallelism at once:

    tiles  (I, P, T, B, B)   I sharded over data, P sharded over model
    ranks  (I, P, Vp)        same

Each rank holds I/|data| instances x P/|model| partitions; the spatial
boundary exchange runs over ``model`` ONLY (instances never talk),
through whichever ``repro_torch.core.comm`` backend the deployment picks,
and the eventually-dependent Merge is a SUM over ``data`` divided by the
summed instance count.

``make_temporal_runner`` is the explicit builder over global tensors;
concrete executions go through
:class:`repro_torch.core.engine.TemporalEngine`, which generalizes the
same placement to every semiring program and stages each rank's shard
only; ``pagerank_temporal`` is the engine-backed host wrapper kept for
the paper's independent-pattern workload.  Every rank calls these with
the same inputs and gets the global result.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.blocked import BlockedGraph
from repro_torch.core.comm import (all_gather, all_reduce, axis_group,
                                   make_comm)
from repro_torch.core.superstep import DeviceGraph, pagerank_step
from repro_torch.kernels.walk_plan import default_chunk, to_device, walk_plan


def make_temporal_runner(
    mesh,
    run_one: Callable[[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]],
                      torch.Tensor],
    *,
    data_axis: Union[str, Tuple[str, ...]] = "data",
    model_axes: Tuple[str, ...] = ("model",),
    merge: bool = True,
):
    """Place a per-instance local program on the temporal-parallel mesh.

    ``run_one(tiles_l (P_l, T, B, B), btiles_l, struct)`` computes one
    instance's final vertex state (P_l, Vp) on the local partition shard
    (collectives over ``model_axes`` only — typically a comm backend
    bound to those axes).  ``struct`` holds the shard's ``rows``,
    ``cols``, ``brows``, ``bcols``, ``out_slot``, ``out_local``,
    ``out_mask``, ``vmask`` and the kernels' walk plans ``plan`` and
    ``bplan``.  The returned fn takes the GLOBAL (I, P, ...) tile tensors
    and (P, ...) structure, runs ``run_one`` over this rank's instances
    (I/|data| of them, contiguous) and partitions (P/|model|), and
    returns the global states (I, P, Vp) and, when ``merge``, the
    across-instance mean (P, Vp) — one SUM over the data group divided
    by the summed instance count — else zeros.  I must divide by the
    data size and P by the model size.
    """
    model = axis_group(mesh, model_axes)
    data = axis_group(mesh, data_axis)

    def fn(tiles, btiles, rows, cols, brows, bcols,
           out_slot, out_local, out_mask, vmask):
        I, P = int(tiles.shape[0]), int(rows.shape[0])
        assert I % data.size == 0 and P % model.size == 0, \
            f"({I} instances, {P} partitions) do not shard over " \
            f"(data {data.size}, model {model.size})"
        ni, npt = I // data.size, P // model.size
        i0, p0 = data.rank * ni, model.rank * npt

        def mine(a):
            return a.narrow(0, p0, npt)

        B = tiles.shape[-1]
        nvb = vmask.shape[-1] // B
        struct = {k: mine(v) for k, v in dict(
            rows=rows, cols=cols, brows=brows, bcols=bcols,
            out_slot=out_slot, out_local=out_local, out_mask=out_mask,
            vmask=vmask).items()}
        for k, c in (("plan", "cols"), ("bplan", "bcols")):
            struct[k] = to_device(walk_plan(
                struct[c].cpu().numpy(), nvb, chunk=default_chunk(B)),
                tiles.device)
        states = torch.stack([
            run_one(tiles[i].narrow(0, p0, npt),
                    btiles[i].narrow(0, p0, npt), struct)
            for i in range(i0, i0 + ni)])
        if merge:
            total = all_reduce(torch.sum(states, dim=0), data, "sum")
            n = all_reduce(torch.tensor(float(ni)), data, "sum")
            merged = total / n.to(total.device)
        else:
            merged = torch.zeros_like(states[0])
        states = torch.cat(all_gather(states, data), dim=0)
        return (torch.cat(all_gather(states, model), dim=1),
                torch.cat(all_gather(merged, model), dim=0))

    return fn


def make_temporal_pagerank(
    mesh,
    *,
    block_size: int,
    num_boundary: int,
    num_vertices: int,
    damping: float = 0.85,
    iters: int = 30,
    data_axis: Union[str, Tuple[str, ...]] = "data",
    model_axes: Tuple[str, ...] = ("model",),
    merge: bool = True,
    comm="dense",
    use_pallas=None,
):
    """The temporal-parallel PageRank (the paper's independent-pattern
    workload) on top of :func:`make_temporal_runner`.

    Inputs (global shapes): tiles (I, P, T, B, B), btiles (I, P, Tb, B,
    B), struct tensors (P, ...).  Returns ranks (I, P, Vp) and, when
    ``merge``, the across-instance mean rank (P, Vp).  A fixed iteration
    count keeps every instance's loop in lockstep.  ``comm`` picks the
    boundary exchange backend (``repro_torch.core.comm``)."""
    comm = make_comm(comm, mesh=mesh, model_axes=model_axes)

    def run_one(tiles, btiles, struct):
        dg = DeviceGraph(
            block_size=block_size, num_boundary=num_boundary,
            tiles=tiles, btiles=btiles, **struct)
        r = torch.where(dg.vmask, 1.0 / num_vertices, 0.0)
        for _ in range(iters):
            r = pagerank_step(r, dg, comm, damping=damping,
                              num_vertices=num_vertices,
                              use_pallas=use_pallas)
        return r

    return make_temporal_runner(
        mesh, run_one, data_axis=data_axis, model_axes=model_axes,
        merge=merge)


def pagerank_temporal(
    bg: BlockedGraph,
    src: np.ndarray,
    instance_active: np.ndarray,  # (I, E)
    mesh,
    *,
    num_vertices: int,
    damping: float = 0.85,
    iters: int = 30,
    data_axis: Union[str, Tuple[str, ...]] = "data",
    model_axes: Tuple[str, ...] = ("model",),
    comm="dense",
    device="cuda",
    use_pallas=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: each rank stages its instances of its partitions and
    runs them concurrently through the TemporalEngine (eventually
    pattern, ``merge="mean"``).  Returns (ranks (I, V), merged mean rank
    (V,)), the same on every rank."""
    from repro_torch.core.algorithms.pagerank import \
        edge_weights_for_instances
    from repro_torch.core.engine import TemporalEngine, pagerank_program

    w = edge_weights_for_instances(src, instance_active, num_vertices)
    eng = TemporalEngine(
        bg, device=device, mesh=mesh, data_axis=data_axis,
        model_axes=model_axes, comm=comm, use_pallas=use_pallas)
    res = eng.run(
        pagerank_program(num_vertices, damping=damping, iters=iters),
        w, pattern="eventually", merge="mean")
    return res.values, res.merged
