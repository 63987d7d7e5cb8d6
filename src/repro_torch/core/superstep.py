"""Sub-graph-centric BSP supersteps on blocked graphs, stacked on one device.

Counterpart of ``repro.core.superstep``: the paper's superstep semantics as
linear algebra.

* one *superstep* = (optional) local convergence inside each partition
  followed by ONE boundary exchange;
* *sub-graph-centric* mode iterates the local semiring SpMV to fixpoint
  before exchanging (the paper's "do much local work per message" trade) —
  valid for idempotent semirings (SSSP, reachability, components);
* *vertex-centric* mode does exactly one local sweep per superstep — the
  Pregel baseline.  Same code path, one knob.

Partitions sit on the leading axis of every tensor, and each kernel takes
all of them in one launch.  The query axis (Q source states in one pass)
adds a leading Q, and each kernel takes every lane in the same launch.
The reference's ``jax.lax.while_loop`` drivers (``vmap``ped over the
query axis) are Python loops here with the same caps, lane by lane, and
every halt vote is one device-to-host read of all lanes' votes, counted
in the ``host_syncs`` stat.

On a mesh (a comm backend bound by ``make_comm(mesh=...)``) the tensors
hold this rank's partition shard, and the votes go through the backend:
a superstep's and a local sweep's lane votes are ORed over the model
group, so every shard runs the stacked run's supersteps and sweeps, lane
by lane.  :func:`make_spmd_superstep` is the reference's explicit
one-superstep mesh program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocked import BlockedGraph
from repro_torch.core.comm import CommBackend, DenseAllReduce
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL, Semiring
from repro_torch.kernels.semiring_spmm.ops import spmv_blocked
from repro_torch.kernels.semiring_superstep.ops import fused_step
from repro_torch.kernels.walk_plan import (
    WalkPlan, default_chunk, to_device, walk_plan)

#: Engine kernel modes: ``"off"`` is the plain PyTorch oracle (CPU only),
#: ``"spmv"`` the per-stage blocked SpMV kernel, ``"fused"`` the
#: single-launch superstep kernel (sweep + semiring combine + halt vote).
KERNEL_MODES = ("off", "spmv", "fused")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    there is none (nothing falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run on the CPU through the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def kernel_mode(use_pallas, device) -> str:
    """Normalize the ``use_pallas`` knob for tensors on ``device``.

    The knob keeps the reference's name and values: a mode string from
    :data:`KERNEL_MODES`, ``True`` (spmv), ``False`` (off) or ``None``,
    which picks ``"spmv"`` on CUDA (the reference planner's dense-regime
    choice) and ``"off"`` on the CPU.  On CUDA, ``"off"`` raises: the
    plain versions are test oracles there, not an execution path.
    """
    cuda = torch.device(device).type == "cuda"
    if use_pallas is None:
        mode = "spmv" if cuda else "off"
    elif use_pallas is False:
        mode = "off"
    elif use_pallas is True:
        mode = "spmv"
    elif use_pallas in KERNEL_MODES:
        mode = use_pallas
    else:
        raise ValueError(
            f"unknown kernel mode {use_pallas!r}: pick from {KERNEL_MODES}")
    if cuda and mode == "off":
        raise ValueError(
            "kernel mode 'off' runs the plain PyTorch versions, which are "
            "test oracles on the card; use 'spmv' or 'fused' on CUDA")
    return mode


@dataclass
class DeviceGraph:
    """Device-resident blocked structure+values, leading partition axis."""

    block_size: int
    num_boundary: int
    rows: torch.Tensor  # (P, T) int32
    cols: torch.Tensor  # (P, T) int32
    tiles: torch.Tensor  # (P, T, B, B) float32 — per-instance values
    brows: torch.Tensor  # (P, Tb) int32 (boundary block index)
    bcols: torch.Tensor  # (P, Tb) int32 (local dst block index)
    btiles: torch.Tensor  # (P, Tb, B, B) float32 — per-instance values
    out_slot: torch.Tensor  # (P, O) int32
    out_local: torch.Tensor  # (P, O) int32
    out_mask: torch.Tensor  # (P, O) bool
    vmask: torch.Tensor  # (P, Vp) bool valid-vertex mask
    # the kernels' walk plans of (rows, cols) and (brows, bcols), built
    # once per tile index (kernels/walk_plan.py)
    plan: WalkPlan
    bplan: WalkPlan

    @property
    def n_parts(self) -> int:
        return self.rows.shape[0]

    @property
    def vp(self) -> int:
        return self.vmask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def device_graph(
    bg: BlockedGraph,
    local_vals: np.ndarray,  # (P, T, B, B) from bg.fill_local
    boundary_vals: np.ndarray,  # (P, Tb, B, B) from bg.fill_boundary
    *,
    device="cuda",
) -> DeviceGraph:
    dev = resolve_device(device)
    P, O = bg.out_slot.shape
    out_mask = np.arange(O)[None, :] < bg.n_out[:, None]

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return DeviceGraph(
        block_size=bg.block_size,
        num_boundary=bg.num_boundary,
        rows=put(bg.tiles_rc[:, :, 0]),
        cols=put(bg.tiles_rc[:, :, 1]),
        tiles=put(np.asarray(local_vals, np.float32)),
        brows=put(bg.btiles_rc[:, :, 0]),
        bcols=put(bg.btiles_rc[:, :, 1]),
        btiles=put(np.asarray(boundary_vals, np.float32)),
        out_slot=put(bg.out_slot),
        out_local=put(bg.out_local),
        out_mask=put(out_mask),
        vmask=put(bg.global_of >= 0),
        **graph_plans(bg, dev),
    )


def graph_plans(bg: BlockedGraph, device,
                parts: Optional[Tuple[int, int]] = None
                ) -> Dict[str, WalkPlan]:
    """``plan`` and ``bplan`` of ``bg``'s local and boundary tile index
    (``parts``: of that half-open partition range only, a cluster
    shard's), built on the host and put on ``device``."""
    nvb, chunk = bg.vp // bg.block_size, default_chunk(bg.block_size)
    lo, hi = (0, bg.n_parts) if parts is None else parts
    return {"plan": to_device(walk_plan(bg.tiles_rc[lo:hi, :, 1], nvb,
                                        chunk=chunk), device),
            "bplan": to_device(walk_plan(bg.btiles_rc[lo:hi, :, 1], nvb,
                                         chunk=chunk), device)}


# ---------------------------------------------------------------------------
# Step primitives.  ``mode`` is a kernel mode already resolved by
# :func:`kernel_mode` ("off" | "spmv" | "fused"); the drivers resolve it once.
# ---------------------------------------------------------------------------

def _blocks(x: torch.Tensor, dg: DeviceGraph) -> torch.Tensor:
    """([Q,] P, Vp) state -> ([Q,] P, NVB, B) block view for the fused
    kernel."""
    return x.reshape(*x.shape[:-1], -1, dg.block_size)


def _shared(boundary: torch.Tensor, dg: DeviceGraph) -> torch.Tensor:
    """([Q,] NB) combined boundary -> ([Q,] 1, NBB, B): one x shared by
    every partition (the consume's input), one per lane."""
    return boundary.reshape(*boundary.shape[:-1], 1, -1, dg.block_size)


def _fused_sweep_vote(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused sweep: x' = add(x, A^T x) plus the per-(lane, partition)
    halt vote vs the pre-sweep state, in one launch."""
    xs = _blocks(x, dg)
    xo, changed = fused_step(dg.tiles, dg.rows, dg.cols, xs, xs, xs,
                             _blocks(dg.vmask, dg), sr, plan=dg.plan)
    return xo.reshape(x.shape), changed


def _fused_consume_vote(
    x: torch.Tensor, boundary: torch.Tensor, dg: DeviceGraph, sr: Semiring,
    x_ref: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused boundary consume: x' = add(x, R^T boundary), voting against
    ``x_ref`` (the superstep start) in-kernel."""
    xs = _blocks(x, dg)
    xo, changed = fused_step(
        dg.btiles, dg.brows, dg.bcols, _shared(boundary, dg), xs,
        _blocks(x_ref, dg), _blocks(dg.vmask, dg), sr, plan=dg.bplan)
    return xo.reshape(x.shape), changed


def _local_sweep(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring, mode: str
) -> torch.Tensor:
    """One relaxation sweep of every partition (and lane): x' = add(x,
    A^T x)."""
    if mode == "fused":
        return _fused_sweep_vote(x, dg, sr)[0]
    y = spmv_blocked(dg.tiles, dg.rows, dg.cols, x, sr,
                     use_kernel=mode == "spmv", plan=dg.plan)
    return sr.add(x, y)


def _spmv_only(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring, mode: str
) -> torch.Tensor:
    """Plain y = A^T x per partition (no combine with x) — PageRank path."""
    if mode == "fused":
        # no combine and no vote: the fused kernel degenerates to the
        # plain SpMV (the reference combines with a zero state and drops
        # the vote, to the same values)
        xs = _blocks(x, dg)
        xo, _ = fused_step(dg.tiles, dg.rows, dg.cols, xs, None, None, None,
                           sr, n_out_blocks=xs.shape[-2], plan=dg.plan)
        return xo.reshape(x.shape)
    return spmv_blocked(dg.tiles, dg.rows, dg.cols, x, sr,
                        use_kernel=mode == "spmv", plan=dg.plan)


def _lane_votes(changed: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """([Q,] P, ...) per-partition votes -> (Q,) per-lane vote (Q = 1 for
    a state with no query axis)."""
    return changed.reshape(n_lanes, -1).any(dim=1)


def _keep_stopped(new: torch.Tensor, old: torch.Tensor,
                  live: np.ndarray) -> torch.Tensor:
    """``new`` on the lanes still running, ``old`` (bitwise) on the lanes
    whose loop has ended: a stopped lane's state never moves again, even
    where another sweep would still change it (a lane stopped by a cap).
    The loops launch only while a lane runs, so a state with no query
    axis (one lane) never needs the select."""
    if live.all():
        return new
    keep = torch.as_tensor(live, device=new.device)[:, None, None]
    return torch.where(keep, new, old)


def _local_converge(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring, mode: str,
    max_sweeps: int, live: np.ndarray, comm: CommBackend,
) -> Tuple[torch.Tensor, np.ndarray, int]:
    """Sweep every lane in ``live`` ((Q,) bool) to local fixpoint
    (idempotent sr), lane by lane as a vmapped ``while_loop`` does: lane
    q sweeps while its own vote says it changed and its count is under
    ``max_sweeps``; the other lanes keep their state.  One launch a sweep
    serves all lanes, and its (Q,) vote is one host read.  ``x`` is (Q,
    P, Vp), or (P, Vp) for one lane.  Returns (x, sweeps (Q,),
    host_syncs).  The vote of the last permitted sweep is not read: the
    loop ends whatever it says.  ``comm``'s ``local_vote`` globalizes
    each vote (the identity unless the backend is bound to a mesh)."""
    Q = len(live)
    sweeps = np.zeros(Q, np.int64)
    syncs, it = 0, 0
    act = live.copy()
    while act.any() and it < max_sweeps:
        if mode == "fused":
            # the kernel's per-(lane, partition) vote is ready-made: the
            # loop reads Q x P flags instead of comparing two states
            xn, chv = _fused_sweep_vote(x, dg, sr)
            flag = _lane_votes(chv, Q)
        else:
            xn = _local_sweep(x, dg, sr, mode)
            flag = _lane_votes(dg.vmask & (xn != x), Q)
        x = _keep_stopped(xn, x, act)
        sweeps += act
        it += 1
        if it < max_sweeps:
            act &= comm.local_vote(flag.cpu().numpy())
            syncs += 1
    return x, sweeps, syncs


def _publish(x: torch.Tensor, dg: DeviceGraph, sr: Semiring,
             comm: CommBackend) -> torch.Tensor:
    """Scatter owned boundary-vertex values into the global boundary buffer
    and combine across partitions.  Returns ([Q,] NB).  Masked padding
    entries point at slot 0 with value ``sr.zero``: the scatter
    accumulates, so they leave the real slot unchanged."""
    lead = tuple(x.shape[:-2])
    vals = torch.gather(x, -1, dg.out_local.long().expand(*lead, -1, -1))
    vals = vals.masked_fill(~dg.out_mask, sr.zero)
    buf = sr.full(lead + (x.shape[-2], dg.num_boundary), x.dtype, x.device)
    buf = sr.scatter_add(buf, dg.out_slot.expand(*lead, -1, -1), vals)
    return comm.combine_boundary(buf, sr)


def _consume(
    x: torch.Tensor, boundary: torch.Tensor, dg: DeviceGraph, sr: Semiring,
    mode: str, combine: bool = True,
) -> torch.Tensor:
    """Apply incoming cut edges: y = R^T boundary; x' = add(x, y), or y
    alone when ``combine`` is False (``x`` then only gives the shape)."""
    if mode == "fused":
        # nobody reads a vote here: the kernel skips it
        xo, _ = fused_step(
            dg.btiles, dg.brows, dg.bcols, _shared(boundary, dg),
            _blocks(x, dg) if combine else None, None, None, sr,
            n_out_blocks=dg.vp // dg.block_size, plan=dg.bplan)
        return xo.reshape(x.shape)
    y = spmv_blocked(dg.btiles, dg.brows, dg.bcols,
                     boundary.reshape(*boundary.shape[:-1], 1, -1),
                     sr, n_out_blocks=dg.vp // dg.block_size,
                     use_kernel=mode == "spmv", plan=dg.bplan)
    return sr.add(x, y) if combine else y


# ---------------------------------------------------------------------------
# BSP drivers
# ---------------------------------------------------------------------------

def bsp_fixpoint(
    x0: torch.Tensor,  # ([Q,] P, Vp) initial vertex values
    dg: DeviceGraph,
    sr: Semiring = MIN_PLUS,
    *,
    comm: Optional[CommBackend] = None,
    subgraph_centric: bool = True,
    max_supersteps: int = 64,
    max_local_sweeps: int = 1024,
    use_pallas=None,
) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Run BSP supersteps until global fixpoint (idempotent semirings).

    Returns (x, stats) with stats = {supersteps, local_sweeps, host_syncs}
    as int32.  ``subgraph_centric=False`` gives the vertex-centric
    (Pregel) baseline: exactly one local sweep per superstep.

    The query axis: ``x0`` of shape (Q, P, Vp) runs Q states in one pass,
    with the semantics of the reference's ``vmap`` of this loop.  Every
    lane halts at its own fixpoint: lane q's superstep loop runs while its
    own vote is set and its count is under ``max_supersteps``, and a lane
    whose loop has ended keeps its state bitwise.  Each launch serves all
    Q lanes, and each vote is one (Q,) host read whatever Q is, so a pass
    takes as many launches as its slowest lanes need.  ``supersteps`` and
    ``local_sweeps`` are then (Q,), each lane's own, and ``host_syncs``
    counts the batched run's reads.

    The loop goes on while ``comm.keep_running`` says a lane is live
    somewhere: the identity, except for a ring bound to ``sync_axes``
    (``CommBackend.bind_sync``), whose ranks then run on, with no lane
    live, until every concurrent data shard's loop has ended — those
    iterations take that vote and nothing else, so no count moves.
    """
    assert sr.idempotent, "bsp_fixpoint needs an idempotent semiring"
    comm = DenseAllReduce() if comm is None else comm
    sweeps_cap = max_local_sweeps if subgraph_centric else 1
    mode = kernel_mode(use_pallas, dg.device)
    lanes = x0.ndim == 3
    x = x0
    Q = x.shape[0] if lanes else 1
    live = np.ones(Q, bool)
    supersteps = np.zeros(Q, np.int64)
    local_sweeps = np.zeros(Q, np.int64)
    syncs, it = 0, 0
    running = True
    while running and it < max_supersteps:
        stepped = live.any()
        if stepped:
            x_start = x
            x, s, n = _local_converge(x_start, dg, sr, mode, sweeps_cap,
                                      live, comm)
            boundary = _publish(x, dg, sr, comm)
            # vote-to-halt compares against the superstep START: in
            # vertex-centric mode the single local sweep can progress even
            # when the boundary exchange is quiet.
            if mode == "fused":
                # the consume kernel emits the vote: Q x P flags, never a
                # re-read of the full states
                xn, chv = _fused_consume_vote(x, boundary, dg, sr, x_start)
                flag = _lane_votes(chv, Q)
            else:
                xn = _consume(x, boundary, dg, sr, mode)
                flag = _lane_votes(dg.vmask & (xn != x_start), Q)
            x = _keep_stopped(xn, x_start, live)
            supersteps += live
            local_sweeps += s
            syncs += n
        it += 1
        if it < max_supersteps:
            if stepped:
                live &= comm.any_changed(flag.cpu().numpy())
                syncs += 1
            running = comm.keep_running(bool(live.any()))
    stats = {"supersteps": supersteps.astype(np.int32),
             "local_sweeps": local_sweeps.astype(np.int32),
             "host_syncs": np.int32(syncs)}
    if not lanes:
        stats.update(supersteps=stats["supersteps"][0],
                     local_sweeps=stats["local_sweeps"][0])
    return x, stats


def pagerank_step(
    rank: torch.Tensor,  # (P, Vp)
    dg: DeviceGraph,  # tiles already hold 1/out_degree weights
    comm: Optional[CommBackend] = None,
    *,
    damping: float = 0.85,
    num_vertices: int,
    use_pallas=None,
) -> torch.Tensor:
    """One PageRank superstep: contribution SpMV + boundary exchange."""
    comm = DenseAllReduce() if comm is None else comm
    mode = kernel_mode(use_pallas, dg.device)
    contrib = _spmv_only(rank, dg, PLUS_MUL, mode)
    boundary = _publish(rank, dg, PLUS_MUL, comm)
    contrib = contrib + _consume(rank, boundary, dg, PLUS_MUL, mode,
                                 combine=False)
    base = (1.0 - damping) / num_vertices
    return torch.where(dg.vmask, base + damping * contrib, 0.0)


def pagerank_run(
    dg: DeviceGraph,
    comm: Optional[CommBackend] = None,
    *,
    damping: float = 0.85,
    num_vertices: int,
    iters: int = 30,
    tol: float = 0.0,
    use_pallas=None,
) -> Tuple[torch.Tensor, int]:
    """PageRank to ``iters`` supersteps (or L1 tolerance).  Returns
    (rank (P, Vp), supersteps).  Each tolerance check is one host read."""
    comm = DenseAllReduce() if comm is None else comm
    mode = kernel_mode(use_pallas, dg.device)
    r = torch.where(dg.vmask, 1.0 / num_vertices, 0.0)
    delta, it = float("inf"), 0
    while delta > tol and it < iters:
        rn = pagerank_step(r, dg, comm, damping=damping,
                           num_vertices=num_vertices, use_pallas=mode)
        it += 1
        if it < iters:
            delta = float(comm.sum_scalar(torch.sum(torch.abs(rn - r))))
        r = rn
    return r, it


# ---------------------------------------------------------------------------
# The explicit one-superstep mesh program
# ---------------------------------------------------------------------------

def make_spmd_superstep(mesh, sr: Semiring = MIN_PLUS, *, use_pallas=None,
                        comm="dense"):
    """One BSP superstep as an explicit mesh program (counterpart of the
    reference's ``shard_map`` one): partitions are sharded over ALL mesh
    dims (rank-major over the mesh's dims, one contiguous range a rank);
    the boundary exchange is one combine of the ([Q,] NB) buffer through
    the chosen backend bound to every dim.

    Returns ``superstep_with_nb(nb)`` -> ``run(x, rows, cols, tiles,
    brows, bcols, btiles, out_slot, out_local, out_mask, vmask)``, which
    every rank calls with the same GLOBAL tensors (leading partition
    axis; ``x`` ([Q,] P, Vp)): each rank takes its shard, runs one local
    sweep, the exchange and the consume, and all ranks get the global
    ([Q,] P, Vp) result, gathered in rank order.  P must divide by the
    mesh's size.
    """
    from repro_torch.core.comm import (all_gather, axis_group, make_comm,
                                       mesh_dims)

    axes = tuple(mesh_dims(mesh))
    comm = make_comm(comm, mesh=mesh, model_axes=axes)
    g = axis_group(mesh, axes)

    def superstep_with_nb(nb: int):
        def run(x, rows, cols, tiles, brows, bcols, btiles,
                out_slot, out_local, out_mask, vmask):
            P = rows.shape[0]
            assert P % g.size == 0, \
                f"{P} partitions do not shard evenly over {g.size} ranks"
            n = P // g.size
            lo = g.rank * n

            def mine(a, axis=0):
                return a.narrow(axis, lo, n)

            B = tiles.shape[-1]
            nvb = vmask.shape[-1] // B
            chunk = default_chunk(B)
            dg = DeviceGraph(
                block_size=B, num_boundary=nb,
                rows=mine(rows), cols=mine(cols), tiles=mine(tiles),
                brows=mine(brows), bcols=mine(bcols), btiles=mine(btiles),
                out_slot=mine(out_slot), out_local=mine(out_local),
                out_mask=mine(out_mask), vmask=mine(vmask),
                plan=to_device(walk_plan(mine(cols).cpu().numpy(), nvb,
                                         chunk=chunk), x.device),
                bplan=to_device(walk_plan(mine(bcols).cpu().numpy(), nvb,
                                          chunk=chunk), x.device))
            mode = kernel_mode(use_pallas, x.device)
            x1 = _local_sweep(mine(x, -2), dg, sr, mode)
            boundary = _publish(x1, dg, sr, comm)
            out = _consume(x1, boundary, dg, sr, mode)
            return torch.cat(all_gather(out, g), dim=-2)

        return run

    return superstep_with_nb
