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
all of them in one launch.  The reference's ``jax.lax.while_loop`` drivers
are Python loops here with the same caps, and every halt vote is one
device-to-host read, counted in the ``host_syncs`` stat.
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
    )


# ---------------------------------------------------------------------------
# Step primitives.  ``mode`` is a kernel mode already resolved by
# :func:`kernel_mode` ("off" | "spmv" | "fused"); the drivers resolve it once.
# ---------------------------------------------------------------------------

def _blocks(x: torch.Tensor, dg: DeviceGraph) -> torch.Tensor:
    """(P, Vp) state -> (P, NVB, B) block view for the fused kernel."""
    return x.reshape(x.shape[0], -1, dg.block_size)


def _fused_sweep_vote(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused sweep: x' = add(x, A^T x) plus the per-partition halt
    vote vs the pre-sweep state, in one launch."""
    xs = _blocks(x, dg)
    xo, changed = fused_step(dg.tiles, dg.rows, dg.cols, xs, xs, xs,
                             _blocks(dg.vmask, dg), sr)
    return xo.reshape(x.shape), changed


def _fused_consume_vote(
    x: torch.Tensor, boundary: torch.Tensor, dg: DeviceGraph, sr: Semiring,
    x_ref: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused boundary consume: x' = add(x, R^T boundary), voting against
    ``x_ref`` (the superstep start) in-kernel."""
    xs = _blocks(x, dg)
    xo, changed = fused_step(
        dg.btiles, dg.brows, dg.bcols,
        boundary.reshape(1, -1, dg.block_size), xs, _blocks(x_ref, dg),
        _blocks(dg.vmask, dg), sr)
    return xo.reshape(x.shape), changed


def _local_sweep(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring, mode: str
) -> torch.Tensor:
    """One relaxation sweep of every partition: x' = add(x, A^T x)."""
    if mode == "fused":
        return _fused_sweep_vote(x, dg, sr)[0]
    y = spmv_blocked(dg.tiles, dg.rows, dg.cols, x, sr,
                     use_kernel=mode == "spmv")
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
                           sr, n_out_blocks=xs.shape[1])
        return xo.reshape(x.shape)
    return spmv_blocked(dg.tiles, dg.rows, dg.cols, x, sr,
                        use_kernel=mode == "spmv")


def _local_converge(
    x: torch.Tensor, dg: DeviceGraph, sr: Semiring, mode: str,
    max_sweeps: int,
) -> Tuple[torch.Tensor, int, int]:
    """Sweep to local fixpoint (idempotent sr).  Returns (x, n_sweeps,
    host_syncs).  The vote of the last permitted sweep is not read: the
    loop ends whatever it says."""
    changed, sweeps, syncs = True, 0, 0
    while changed and sweeps < max_sweeps:
        if mode == "fused":
            # the kernel's per-partition vote is ready-made: the loop
            # reads P flags instead of comparing two (P, Vp) states
            xn, chv = _fused_sweep_vote(x, dg, sr)
            flag = chv.any()
        else:
            xn = _local_sweep(x, dg, sr, mode)
            flag = (dg.vmask & (xn != x)).any()
        sweeps += 1
        if sweeps < max_sweeps:
            changed = bool(flag.item())
            syncs += 1
        x = xn
    return x, sweeps, syncs


def _publish(x: torch.Tensor, dg: DeviceGraph, sr: Semiring,
             comm: CommBackend) -> torch.Tensor:
    """Scatter owned boundary-vertex values into the global boundary buffer
    and combine across partitions.  Returns (NB,).  Masked padding entries
    point at slot 0 with value ``sr.zero``: the scatter accumulates, so
    they leave the real slot unchanged."""
    vals = torch.gather(x, 1, dg.out_local.long())
    vals = vals.masked_fill(~dg.out_mask, sr.zero)
    buf = sr.full((x.shape[0], dg.num_boundary), x.dtype, x.device)
    buf = sr.scatter_add(buf, dg.out_slot, vals)
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
            dg.btiles, dg.brows, dg.bcols,
            boundary.reshape(1, -1, dg.block_size),
            _blocks(x, dg) if combine else None, None, None, sr,
            n_out_blocks=dg.vp // dg.block_size)
        return xo.reshape(x.shape)
    y = spmv_blocked(dg.btiles, dg.brows, dg.bcols, boundary.reshape(1, -1),
                     sr, n_out_blocks=dg.vp // dg.block_size,
                     use_kernel=mode == "spmv")
    return sr.add(x, y) if combine else y


# ---------------------------------------------------------------------------
# BSP drivers
# ---------------------------------------------------------------------------

def bsp_fixpoint(
    x0: torch.Tensor,  # (P, Vp) initial vertex values
    dg: DeviceGraph,
    sr: Semiring = MIN_PLUS,
    *,
    comm: Optional[CommBackend] = None,
    subgraph_centric: bool = True,
    max_supersteps: int = 64,
    max_local_sweeps: int = 1024,
    use_pallas=None,
) -> Tuple[torch.Tensor, Dict[str, np.int32]]:
    """Run BSP supersteps until global fixpoint (idempotent semirings).

    Returns (x, stats) with stats = {supersteps, local_sweeps, host_syncs}
    as int32.  ``subgraph_centric=False`` gives the vertex-centric
    (Pregel) baseline: exactly one local sweep per superstep.
    """
    assert sr.idempotent, "bsp_fixpoint needs an idempotent semiring"
    comm = DenseAllReduce() if comm is None else comm
    sweeps_cap = max_local_sweeps if subgraph_centric else 1
    mode = kernel_mode(use_pallas, dg.device)
    x = x0
    changed, supersteps, local_sweeps, syncs = True, 0, 0, 0
    while changed and supersteps < max_supersteps:
        x_start = x
        x, s, n = _local_converge(x_start, dg, sr, mode, sweeps_cap)
        boundary = _publish(x, dg, sr, comm)
        # vote-to-halt compares against the superstep START: in
        # vertex-centric mode the single local sweep can progress even when
        # the boundary exchange is quiet.
        if mode == "fused":
            # the consume kernel emits the vote: P flags, never a re-read
            # of the full states
            x, chv = _fused_consume_vote(x, boundary, dg, sr, x_start)
            flag = chv.any()
        else:
            xn = _consume(x, boundary, dg, sr, mode)
            flag = (dg.vmask & (xn != x_start)).any()
            x = xn
        supersteps += 1
        local_sweeps += s
        syncs += n
        if supersteps < max_supersteps:
            changed = comm.any_changed(bool(flag.item()))
            syncs += 1
    return x, {"supersteps": np.int32(supersteps),
               "local_sweeps": np.int32(local_sweeps),
               "host_syncs": np.int32(syncs)}


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
