#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. the graph kernels against their plain PyTorch versions on the card,
   both semirings, B in {32, 64, 128}, padding, an empty structure,
   ``nnz`` and the fused call shapes (with and without the combine and
   the vote): min-plus bitwise (same inf pattern), plus-mul within the
   limit of :func:`plus_mul_limit`, halt votes exactly equal;
4. the attention kernels against theirs on FLASH_CASES and DECODE_CASES
   (the sweeps of ``tests/test_kernels.py`` plus ragged tails, G = 9,
   windows past the sequence, length-1 caches, many splits), within
   :func:`attn_limit` (the reference's 2e-5 float32 / 2e-2 bf16, with
   the absolute part scaled to each output row);
5. the graph main path at TR_SMALL (16,384 vertices, 48 instances, 8
   partitions, B=64), dense layout, through ``TemporalEngine.run``:
   sequential SSSP in ``spmv`` and ``fused`` mode (bitwise equal, and
   equal to the numpy oracle), independent PageRank (10 iterations) in both
   modes (within :func:`plus_mul_limit` of each other, and within 1e-4
   relative of the float64 oracle), one eventually/``merge="mean"`` run
   and one sparse-layout run on a few instances; the graph kernels'
   launches are counted by call shape (:func:`call_shapes`);
5b. the query axis (``query_phase``): SSSP with 32 sources (QUERY_LANES)
   as one engine pass over phase 5's staged batch, all 48 instances, in
   spmv and fused mode: every lane bitwise equal across the modes and to
   its own single-source run (all 32 run alone and timed), lane 0 to
   phase 5's run; the batched run's launches equal its vote reads, at
   least the slowest lanes' count and under the single runs' sum; its
   launches are counted by call shape on their own, and both kernels
   must have launched in their Q-lane form; on every graph path the
   launches by walk (``launches_by_walk``) must match the launches by
   call shape, every min-plus call of ``walk_plan.LANE_WALK_MIN`` lanes
   or more on the lane walk;
6. the same graph path from a GoFS deployment (``gofs_path``): the
   collection deployed with ``deploy_collection`` (latency tile maps and
   the delta chain) into a temporary directory; host iBSP SSSP
   (``sssp.run_host``) on the ``GoFSStore``, against the oracle; the
   dense ``load_blocked`` batch equal to the in-memory fill, and
   sequential SSSP from it in both kernel modes equal to phase 5's runs;
   sparse loads from the delta chain and from the full value slices,
   equal to each other, with SSSP on the delta batches equal to the dense
   store run; PageRank from the store's activity within
   :func:`plus_mul_limit` of phase 5's; then the Gopher session on the
   same deployment (``session_phase``): ``GopherSession(store)`` plans
   SSSP (dense, dense comm, async, no delta, cold, ``spmv``, stacked),
   prints ``explain()``, and runs it streamed from the store, bitwise
   equal to the dense store run; the same plan in ``fused`` mode,
   bitwise equal to the fused run; ``run_many`` of sssp, nhop (4 hops)
   and pagerank (10 iterations) with its staging report, sssp bitwise,
   pagerank within :func:`plus_mul_limit` of the store PageRank, nhop's
   histograms equal to ``nhop.oracle``; and the sparse override (the
   streamed delta route, fused), bitwise equal, with its source bytes
   beside its staged bytes; then the query axis through the session:
   SSSP with phase 5b's 32 sources streamed from the store, every lane
   bitwise equal to phase 5b's; N-hop with 4 sources, lane 0 equal to
   the ``run_many`` histograms and the others to ``nhop.oracle`` on the
   first and last instance; ``tracking`` of the plate seen in the most
   timesteps, its trace equal to host iBSP ``tracking.run_host`` on the
   store; each step's wall time, the seconds the engine waited on chunks
   against the seconds it computed, peak pinned bytes, peak device
   memory and host peak RSS.  The graph kernels'
   launches on this path are counted by call shape, and the session's
   on their own;
7. each graph kernel at that path's shapes, with the engine's walk
   plans: device time (20 calls replayed from one CUDA graph) and
   eager-call time, the plain version's device time, the bound and its
   share, and, for plus-mul, one PyTorch call computing the same
   function (a dense batched product); then a skewed control, partition
   0's boundary runs gathered into one output block, held against plain
   and timed; then each call shape in its Q-lane form at Q = 1, 4, 20
   and 32 (QUERY_SWEEP), min-plus bitwise and plus-mul within
   :func:`plus_mul_limit`, timed beside the plain version and, for
   plus-mul, ``torch.bmm`` over the lanes, each row naming the walk it
   launched; a skewed control at Q = 32; the lane walk at Q = 20 and 32
   on tiles with signed-zero weights and a -inf and a NaN weight, with
   lanes of signed zeros, NaN and -inf, against the plain version
   (:func:`same_bits`) and lane by lane against the one-lane kernel;
   the two-tile ±0 control (every walk gives -0 in both tile orders);
   MIN_PLUS's plain folds on the card on ±0 in both orders;
   and wrong controls that must fail the comparison (lanes rolled by
   one; a plus-mul tile dropped). Bounds: bytes over HBM bandwidth, or
   FP32 instructions (an add-min pair is two, an FMA one) over FP32_ISSUE,
   whichever is larger;
8. the LM serving path: starcoder2-7b at full width and depth, random
   weights, ``BatchedServer`` answering 4 prompts of 8,192 tokens with 32
   new tokens each (finite logits, no padded-vocab token, a second run
   giving the same tokens, every prefill flash launch on the bf16 wgmma
   route, every decode launch on the bf16 ring route), then a
   ``torch.profiler`` breakdown of one prefill and four decode steps;
9. teacher forcing at S = 8,192: prefill S + 1 against prefill S then
   decode 1, logits within 5e-2;
10. each attention kernel at the serving run's layer-0 shapes and at the
   ``prefill_32k`` / ``decode_32k`` shapes: held against the plain
   version, with controls (the plain version with the window edge or the
   causal edge one key off, or a 32-key block dropped) that must fail the
   same limit; device, eager, plain, bound and SDPA (memory-efficient
   backend, and for flash also the cuDNN backend where it takes these
   inputs; yardsticks only) times, and the decode kernel's split-count
   sweep (1, 2, 4, 8, 16 splits and the schedule's own count).  The
   decode times are taken with K/V out of L2 (``cold_ms``), as a decode
   step finds them, and also back to back (``warm_ms``); then the
   ``kernels`` JSON line for all four kernels (the attention kernels'
   with their launches by route);
11. the card's line again and the last line: ``{"ok": true, "device":
    {...}}``.

Each main path (graph, query, GoFS graph, the session within it,
serving) runs with every kernel's launch count set to 0 just before it
and read just after; a kernel of the path that was not launched fails
the smoke.

It imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Plus-mul tolerance.  tests/test_kernels.py:46 holds plus-mul to rtol =
# atol = 2e-5 on values of order 1.  PageRank's values are near 1/V, where
# that atol is larger than the values themselves, so the absolute part is
# scaled to the data (see plus_mul_limit).
PLUS_MUL_TOL = 2e-5
# PageRank against the float64 oracle, relative in the same way
ORACLE_TOL = 1e-4
# HBM bandwidth of the one card this smoke has run on (H100 SXM data
# sheet), bytes/s
HBM_CARD, HBM_RATE = "H100 80GB HBM3", 3.35e12
# FP32 instructions a second on the CUDA cores of that card: the data
# sheet's 67 TFLOP/s counts an FMA as two operations (132 SMs x 128 lanes
# x 1.98 GHz); an add or a min is one instruction, as an FMA is
FP32_ISSUE = 67e12 / 2
# lanes of the Q-lane kernel sweep (phase 7): one, N-hop's four,
# tracking's twenty, the query phase's thirty-two
QUERY_SWEEP = (1, 4, 20, 32)


class SmokeFailure(AssertionError):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def hbm_rate(name: str) -> float:
    need(HBM_CARD in name, f"no HBM bandwidth on record for {name!r} (only "
                           f"{HBM_CARD!r}); add its data-sheet rate")
    return HBM_RATE


def plus_mul_limit(ref, tol=PLUS_MUL_TOL):
    """Elementwise limit on |got - ref| for plus-mul results: ``tol *
    (|ref| + min(1, mean |ref|))``.  On values of order 1 that is the JAX
    tests' rtol = atol = ``tol``; on smaller data the absolute part shrinks
    with the data, so a kernel that drops terms or sums in bf16 or TF32
    fails on PageRank's values too."""
    a = ref.abs()
    return tol * (a + min(1.0, float(a.mean()) if a.numel() else 1.0))


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def compare(kern, plain, sr_name: str, what: str):
    """Hold a kernel output against its plain version.  Returns the max
    abs error over finite entries (the inf pattern must match) and the
    largest share of the limit that any entry used (0 for min-plus)."""
    import torch

    k, p = kern.float(), plain.float()
    need(k.shape == p.shape, f"{what}: shape {tuple(k.shape)} vs "
                             f"{tuple(p.shape)}")
    fin_k, fin_p = torch.isfinite(k), torch.isfinite(p)
    need(torch.equal(fin_k, fin_p), f"{what}: inf/nan pattern differs")
    need(torch.equal(torch.isnan(k), torch.isnan(p)),
         f"{what}: nan pattern differs")
    need(torch.equal(k[torch.isinf(k)], p[torch.isinf(p)]),
         f"{what}: infinities differ")
    diff = (k[fin_k] - p[fin_p]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if sr_name == "min_plus":
        need(torch.equal(k.view(torch.int32), p.view(torch.int32)),
             f"{what}: min-plus not bitwise (max err {err})")
        return err, 0.0
    used = float((diff / plus_mul_limit(p[fin_p])).max()) \
        if diff.numel() else 0.0
    need(used <= 1.0, f"{what}: plus-mul error {err} is {used:.3g}x the "
                      f"limit of plus_mul_limit")
    return err, used


def same_bits(kern, plain, what):
    """Min-plus controls that hold NaN: NaN where the plain version has
    NaN, every other entry bit for bit (-0 is not +0).  NaN payloads are
    not compared: the kernels' min.NaN gives the canonical NaN where
    torch.minimum passes an input NaN through."""
    import torch

    need(kern.shape == plain.shape, f"{what}: shape {tuple(kern.shape)} vs "
                                    f"{tuple(plain.shape)}")
    nan = torch.isnan(plain)
    need(torch.equal(torch.isnan(kern), nan), f"{what}: nan pattern differs")
    need(torch.equal(kern[~nan].view(torch.int32),
                     plain[~nan].view(torch.int32)),
         f"{what}: min-plus not bitwise")


def walk_counts():
    """The graph kernels' launches so far by walk (``launches_by_walk``):
    {kernel: {walk: launches}}."""
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda

    return {k.__name__: dict(k.launches_by_walk)
            for k in (spmv_blocked_cuda, fused_step_cuda)}


def check_walks(what, shapes, before, after):
    """The launches of a path by walk (``after`` less ``before``, from
    :func:`walk_counts`) against its launches by call shape: each call
    shape's launches on the walk that ``walk_plan.walk_form`` gives its
    lanes and semiring (every min-plus call of ``LANE_WALK_MIN`` lanes or
    more on the lane walk).  Returns the launches by walk."""
    import re

    from repro_torch.kernels.walk_plan import walk_form

    out = {}
    for kernel, walks in after.items():
        got = {w: n - before[kernel][w] for w, n in walks.items()}
        want = dict.fromkeys(got, 0)
        for (k, call), n in shapes.items():
            if k == kernel:
                m = re.search(r" Q=(\d+)", call)
                sr = "min_plus" if "min_plus" in call else "plus_mul"
                want[walk_form(int(m.group(1)) if m else 1, sr)] += n
        need(got == want, f"{what}: {kernel} launches by walk {got}, by "
                          f"call shape {want}")
        out[kernel] = got
    return out


def random_structure(rng, P, T_valid, T, nvb_out, nvb_in):
    import numpy as np

    rows = np.full((P, T), -1, np.int32)
    cols = np.full((P, T), -1, np.int32)
    for p in range(P):
        n = int(T_valid[p])
        cols[p, :n] = np.sort(rng.integers(0, nvb_out, n))
        rows[p, :n] = rng.integers(0, nvb_in, n)
    return rows, cols


def random_tiles(rng, rows, B, density, zero):
    import numpy as np

    P, T = rows.shape
    tiles = np.full((P, T, B, B), zero, np.float32)
    live = (rng.random((P, T, B, B)) < density) & (rows >= 0)[..., None, None]
    tiles[live] = rng.random(int(live.sum())).astype(np.float32)
    return tiles


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_sweep(device="cuda", seed=0):
    """Returns the number of comparisons made."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref

    rng = np.random.default_rng(seed)
    n = 0

    def t(a):
        return torch.as_tensor(a, device=device)

    for B in (32, 64, 128):
        for sr in (MIN_PLUS, PLUS_MUL):
            for density in (0.05, 0.5):
                P, T, nvb, nbb = 3, 12, 5, 7
                tv = rng.integers(0, T + 1, P)
                tv[0] = T  # one partition with no padding at all
                rows, cols = random_structure(rng, P, tv, T, nvb, nvb)
                tiles = random_tiles(rng, rows, B, density, sr.zero)
                x = rng.random((P, nvb * B)).astype(np.float32)
                if sr is MIN_PLUS:
                    x[0, :B] = np.inf  # unreached vertices
                args = (t(tiles), t(rows), t(cols), t(x), sr)
                tag = f"spmv B={B} {sr.name} d={density}"
                compare(spmv_blocked_cuda(*args), spmv_blocked_ref(*args),
                        sr.name, tag)
                # single-partition form
                one = (t(tiles[1]), t(rows[1]), t(cols[1]), t(x[1]), sr)
                compare(spmv_blocked_cuda(*one), spmv_blocked_ref(*one),
                        sr.name, tag + " single")
                # nnz: the valid count, and a shorter walk
                for nz in (tv, np.maximum(tv - 2, 0)):
                    nzt = t(nz.astype(np.int32))
                    compare(spmv_blocked_cuda(*args, nnz=nzt),
                            spmv_blocked_ref(*args, nnz=nzt), sr.name,
                            tag + f" nnz={nz.tolist()}")
                # shared state (boundary consume), other out-block count
                brows, bcols = random_structure(rng, P, tv, T, nvb, nbb)
                btiles = random_tiles(rng, brows, B, density, sr.zero)
                b = rng.random((1, nbb * B)).astype(np.float32)
                bargs = (t(btiles), t(brows), t(bcols), t(b), sr)
                compare(spmv_blocked_cuda(*bargs, n_out_blocks=nvb),
                        spmv_blocked_ref(*bargs, n_out_blocks=nvb), sr.name,
                        tag + " shared")
                # fused: sweep, consume (shared x_in), plain spmv shape
                xs = t(x.reshape(P, nvb, B))
                xr = t(rng.random((P, nvb, B)).astype(np.float32))
                vm = t(rng.random((P, nvb, B)) < 0.9)
                zero = torch.full_like(xs, sr.zero)
                b3 = t(b.reshape(1, nbb, B))
                loc, bnd = (t(tiles), t(rows), t(cols)), \
                    (t(btiles), t(brows), t(bcols))
                shapes = {
                    "sweep": (*loc, xs, xs, xs),
                    "consume": (*bnd, b3, xs, xr),
                    "spmv": (*loc, xs, zero, xs),
                    # PageRank's step: no combine, no vote
                    "spmv no vote": (*loc, xs, None, None),
                    "consume no vote": (*bnd, b3, None, None),
                    "consume combine no vote": (*bnd, b3, xs, None),
                }
                for name, a in shapes.items():
                    m = None if a[5] is None else vm
                    ko, kc = fused_step_cuda(*a, m, sr, n_out_blocks=nvb)
                    po, pc = fused_step_ref(*a, m, sr, n_out_blocks=nvb)
                    compare(ko, po, sr.name, f"fused {name} {tag}")
                    need((kc is None and pc is None) or torch.equal(kc, pc),
                         f"fused {name} {tag}: votes differ")
                n += 12
        # empty structure: every output block gets the semiring zero
        for sr in (MIN_PLUS, PLUS_MUL):
            rows = np.full((2, 4), -1, np.int32)
            tiles = np.full((2, 4, B, B), sr.zero, np.float32)
            x = np.ones((2, 3 * B), np.float32)
            y = spmv_blocked_cuda(t(tiles), t(rows), t(rows), t(x), sr)
            need(bool((y == sr.zero).all()), f"empty B={B} {sr.name}")
            xs = t(x.reshape(2, 3, B))
            vm = torch.ones_like(xs, dtype=torch.bool)
            xo, ch = fused_step_cuda(t(tiles), t(rows), t(rows), xs, xs,
                                     xs + 1, vm, sr)
            need(torch.equal(xo, xs) and bool((ch == 1).all()),
                 f"empty fused B={B} {sr.name}")
            n += 2
    if device == "cuda":
        torch.cuda.synchronize()
    return n


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(cfg, device="cuda", n_sparse=4, log=print):
    """Drive the port's TemporalEngine at ``cfg``.  Returns a dict of what
    phases 6 and 7 need (the in-memory results, one instance's staged
    tiles and states) and the per-run records."""
    import numpy as np
    import torch

    from repro_torch.core.algorithms import pagerank, sssp
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.engine import (
        TemporalEngine, min_plus_program, pagerank_program, source_init)
    from repro_torch.core.generator import generate_collection
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.semiring import INF

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    runs = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = {"seconds": time.perf_counter() - t0}
        if hasattr(out, "stats"):
            st = out.stats
            ss = int(st["supersteps"].sum())
            runs[name].update(
                supersteps=ss, local_sweeps=int(st["local_sweeps"].sum()),
                host_syncs=int(st["host_syncs"].sum()),
                host_syncs_per_superstep=(
                    int(st["host_syncs"].sum()) / ss if ss else 0.0))
        log(f"phase {name}: " + json.dumps(runs[name]))
        return out

    t0 = time.perf_counter()
    col = generate_collection(cfg)
    tmpl = col.template
    assign = partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
    bg = build_blocked(tmpl, assign, cfg.block_size)
    I, V = len(col), tmpl.num_vertices
    lat = np.stack([col.edge_values(t, sssp.WEIGHT_ATTR) for t in range(I)])
    act = np.stack([col.edge_values(t, pagerank.ACTIVE_ATTR)
                    for t in range(I)])
    prw = pagerank.edge_weights_for_instances(tmpl.src, act, V)
    log(f"phase setup: {json.dumps({'seconds': time.perf_counter() - t0, 'vertices': V, 'edges': tmpl.num_edges, 'instances': I, 'partitions': bg.n_parts, 'block': bg.block_size, 't_max': bg.t_max, 'tb_max': bg.tb_max, 'num_boundary': bg.num_boundary})}")

    sssp_prog = min_plus_program("sssp", init=source_init(0))
    pr_prog = pagerank_program(V, iters=10)
    eng = {m: TemporalEngine(bg, device=device, use_pallas=m)
           for m in ("spmv", "fused")}

    # --- SSSP, sequential, dense: spmv vs fused vs oracle ---------------
    tiles, btiles = timed("stage_sssp", lambda: eng["spmv"].stage(lat, INF))
    keep = {"sssp_tiles": tiles[0].clone(), "sssp_btiles": btiles[0].clone()}
    r_sp = timed("sssp_sequential_spmv", lambda: eng["spmv"].run(
        sssp_prog, pattern="sequential", tiles=tiles, btiles=btiles))
    r_fu = timed("sssp_sequential_fused", lambda: eng["fused"].run(
        sssp_prog, pattern="sequential", tiles=tiles, btiles=btiles))
    n_ev = I
    r_ev = timed("sssp_eventually_mean_fused", lambda: eng["fused"].run(
        sssp_prog, pattern="eventually", merge="mean",
        tiles=tiles[:n_ev], btiles=btiles[:n_ev]))
    # the query phase runs over the same staged batch, then drops it
    keep["staged_sssp"] = (tiles, btiles)
    del tiles, btiles
    eng_sparse = TemporalEngine(bg, device=device, use_pallas="spmv",
                                layout="sparse")
    n_sp = min(I, n_sparse)
    r_sparse = timed("sssp_sequential_sparse_spmv", lambda: eng_sparse.run(
        sssp_prog, lat[:n_sp], pattern="sequential"))
    log(f"sparse layout: {n_sp} instances, occupancy {r_sparse.occupancy}")

    # --- PageRank, independent, dense: spmv vs fused vs oracle ----------
    tiles, btiles = timed("stage_pagerank",
                          lambda: eng["spmv"].stage(prw, 0.0))
    keep.update(pr_tiles=tiles[0].clone(), pr_btiles=btiles[0].clone())
    p_sp = timed("pagerank_independent_spmv", lambda: eng["spmv"].run(
        pr_prog, pattern="independent", tiles=tiles, btiles=btiles))
    p_fu = timed("pagerank_independent_fused", lambda: eng["fused"].run(
        pr_prog, pattern="independent", tiles=tiles, btiles=btiles))
    del tiles, btiles
    if device == "cuda":
        torch.cuda.empty_cache()

    # --- checks ---------------------------------------------------------
    t0 = time.perf_counter()
    need(np.array_equal(r_sp.values, r_fu.values, equal_nan=True),
         "sssp: spmv and fused values differ")
    need(np.array_equal(r_sp.final, r_fu.final), "sssp: finals differ")
    for k in ("supersteps", "local_sweeps"):
        need(np.array_equal(r_sp.stats[k], r_fu.stats[k]),
             f"sssp: {k} differ between spmv and fused")
    ref = sssp.oracle(tmpl.src, tmpl.dst, lat, V, 0)
    fin = np.isfinite(ref)
    need(np.array_equal(np.isfinite(r_sp.final), fin),
         "sssp: reachability differs from the oracle")
    need(np.allclose(r_sp.final[fin], ref[fin], rtol=1e-5, atol=0),
         "sssp: distances differ from the oracle beyond rtol 1e-5")
    need(r_sp.final.shape == (V,) and r_sp.values.shape == (I, V),
         "sssp: result shapes")
    need(np.array_equal(r_ev.values[0], r_sp.values[0]),
         "eventually: instance 0 differs from the sequential run")
    with np.errstate(invalid="ignore"):
        mean = r_ev.values.mean(axis=0)
    need(np.allclose(r_ev.merged, mean, rtol=1e-6, atol=0, equal_nan=True),
         "eventually: merged is not the instance mean")
    need(np.array_equal(r_sparse.values, r_sp.values[:n_sp]),
         "sparse layout differs from dense")
    need(bool(np.isfinite(p_sp.values).all()), "pagerank: non-finite ranks")
    sp_t, fu_t = torch.from_numpy(p_sp.values), torch.from_numpy(p_fu.values)
    d = float((sp_t - fu_t).abs().max())
    d_used = float(((sp_t - fu_t).abs() / plus_mul_limit(sp_t)).max())
    need(d_used <= 1.0, f"pagerank: spmv vs fused differ by {d} "
                        f"({d_used:.3g}x the limit)")
    pr_err = pr_used = 0.0
    for t in range(I):
        o = torch.from_numpy(
            pagerank.oracle(tmpl.src, tmpl.dst, act[t], V, iters=10))
        lim = plus_mul_limit(o, ORACLE_TOL)
        for res in (p_sp, p_fu):
            e = (torch.from_numpy(res.values[t]).double() - o).abs()
            pr_err = max(pr_err, float(e.max()))
            pr_used = max(pr_used, float((e / lim).max()))
    need(pr_used <= 1.0, f"pagerank: oracle error {pr_err} ({pr_used:.3g}x "
                         f"the limit)")
    log(f"phase checks: {json.dumps({'seconds': time.perf_counter() - t0, 'pagerank_spmv_vs_fused': d, 'pagerank_spmv_vs_fused_limit_used': d_used, 'pagerank_vs_oracle': pr_err, 'pagerank_vs_oracle_limit_used': pr_used, 'pagerank_mean_rank': float(sp_t.mean()), 'sssp_reached': int(fin.sum())})}")

    # states for phase 7: the converged SSSP state and its boundary
    x_sssp = torch.as_tensor(
        bg.scatter_vertex(r_sp.final.astype(np.float32), INF), device=device)
    x_pr = torch.as_tensor(bg.scatter_vertex(p_sp.values[0], 0.0),
                           device=device)
    keep.update(bg=bg, x_sssp=x_sssp, x_pr=x_pr, eng=eng["spmv"],
                runs=runs, cut={"sparse_instances": n_sp,
                                "eventually_instances": n_ev})
    # what the GoFS path is held against: the collection, its in-memory
    # matrices, the engines, and their results
    keep["in_memory"] = dict(
        col=col, lat=lat, act=act, engines=eng, sssp_oracle=ref,
        sssp={"spmv": r_sp, "fused": r_fu},
        pagerank={"spmv": p_sp, "fused": p_fu})
    return keep


@contextlib.contextmanager
def call_shapes():
    """Count the graph kernels' launches by call shape while the block
    runs: yields a dict {(kernel, call): launches}, ``call`` named as in
    :func:`kernel_report` ("local sweep min_plus", "consume plus_mul",
    "sweep min_plus", "spmv plus_mul", ...; a Q-lane call of the query
    axis adds " Q=<lanes>", "local sweep min_plus Q=32").  It wraps the
    names through which the engine reaches the wrappers; the wrappers'
    own counts move as before, and the shapes' counts sum to them.  Blocks nest: an inner
    block counts its launches in the outer block's dict too."""
    from repro_torch.kernels.semiring_spmm import kernel as spmm_kernel
    from repro_torch.kernels.semiring_spmm import ops as spmm_ops
    from repro_torch.kernels.semiring_superstep import kernel as step_kernel
    from repro_torch.kernels.semiring_superstep import ops as step_ops

    counts = {}
    real_spmv, real_fused = spmm_ops.spmv_blocked_cuda, \
        step_ops.fused_step_cuda
    # the counts live on the wrappers themselves, whatever wraps them
    k_spmv, k_fused = spmm_kernel.spmv_blocked_cuda, \
        step_kernel.fused_step_cuda

    def add(kernel, call, before, after):
        key = (kernel, call)
        counts[key] = counts.get(key, 0) + after - before

    def lanes(x, rank):  # " Q=<lanes>" for a Q-lane call
        return f" Q={x.shape[0]}" if x.ndim == rank + 1 else ""

    def spmv(tiles, rows, cols, x, sr, **kw):
        n = k_spmv.launches
        out = real_spmv(tiles, rows, cols, x, sr, **kw)
        shape = "consume" if x.shape[-2] == 1 else "local sweep"
        add("spmv_blocked_cuda", f"{shape} {sr.name}{lanes(x, 2)}", n,
            k_spmv.launches)
        return out

    def fused(tiles, rows, cols, x_in, x_comb, *args, **kw):
        n = k_fused.launches
        out = real_fused(tiles, rows, cols, x_in, x_comb, *args, **kw)
        sr = args[2]
        shape = "consume" if x_in.shape[-3] == 1 else (
            "sweep" if x_comb is not None else "spmv")
        add("fused_step_cuda", f"{shape} {sr.name}{lanes(x_in, 3)}", n,
            k_fused.launches)
        return out

    spmm_ops.spmv_blocked_cuda, step_ops.fused_step_cuda = spmv, fused
    try:
        yield counts
    finally:
        spmm_ops.spmv_blocked_cuda = real_spmv
        step_ops.fused_step_cuda = real_fused


# ---------------------------------------------------------------------------
# phase 5b: the query axis on the main path
# ---------------------------------------------------------------------------

# sources of the query phase: the reference service's batch width
# (max_batch_queries, src/repro/gopher/service.py:202)
QUERY_LANES = 32


def query_sources(V, seed=0, lanes=QUERY_LANES):
    """The query phase's sources: lane 0 is vertex 0 (phase 5's source),
    the others drawn from ``seed``; and the lanes held against their own
    single-source runs by name: 0, the last, and two drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    srcs = [0] + [int(v) for v in rng.choice(np.arange(1, V), lanes - 1,
                                             replace=False)]
    drawn = rng.choice(np.arange(1, lanes - 1), 2, replace=False)
    return srcs, sorted({0, lanes - 1, *(int(q) for q in drawn)})


def query_phase(keep, device="cuda", log=print):
    """SSSP with QUERY_LANES sources as one engine pass over phase 5's
    staged TR_SMALL batch (48 instances, dense, sequential), in spmv and
    fused mode: every lane's values, final state and counts bitwise equal
    across the modes; every lane bitwise equal to its own single-source
    run (all 32 run alone over the same batch, spmv, and timed), lane 0
    also to phase 5's run; the spmv launches of the batched run equal its
    host syncs (one launch, then one vote read, per sweep and per
    consume), at least the slowest lanes' counts and far under the single
    runs' sum.  Returns the phase's records; ``keep["query"]`` gets the
    sources and the batched result (the session phase's reference)."""
    import numpy as np
    import torch

    from repro_torch.core.engine import (
        min_plus_program, source_init, sources_init)
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda

    mem, bg = keep["in_memory"], keep["bg"]
    tiles, btiles = keep.pop("staged_sssp")
    eng = mem["engines"]
    V, I = len(bg.part_of), int(tiles.shape[0])
    srcs, sampled = query_sources(V)
    Q = len(srcs)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def run(mode, prog):
        sync()
        n0 = (spmv_blocked_cuda.launches, fused_step_cuda.launches)
        t0 = time.perf_counter()
        r = eng[mode].run(prog, pattern="sequential", tiles=tiles,
                          btiles=btiles)
        sync()
        return r, time.perf_counter() - t0, (
            spmv_blocked_cuda.launches - n0[0],
            fused_step_cuda.launches - n0[1])

    recs = {"sources": srcs, "sampled_lanes": sampled, "lanes": Q,
            "instances": I}
    prog = min_plus_program("sssp", init=sources_init(srcs))
    batched = {}
    for mode in ("spmv", "fused"):
        r, wall, (n_sp, n_fu) = run(mode, prog)
        need(r.values.shape == (Q, I, V) and r.final.shape == (Q, V)
             and r.stats["supersteps"].shape == (Q, I),
             f"query ({mode}): result shapes")
        need(bool((r.final[np.arange(Q), srcs] == 0).all()),
             f"query ({mode}): a source is not at distance 0")
        batched[mode] = r
        per_lane = r.stats["supersteps"] + r.stats["local_sweeps"]
        recs[mode] = dict(
            seconds=wall, launches={"spmv_blocked_cuda": n_sp,
                                    "fused_step_cuda": n_fu},
            host_syncs=int(r.stats["host_syncs"].sum()),
            slowest_lane_launches=int(per_lane.max(0).sum()),
            sum_over_lanes_launches=int(per_lane.sum()),
            supersteps_per_lane_max=int(r.stats["supersteps"].max()),
            local_sweeps_per_lane_max=int(r.stats["local_sweeps"].max()))
        n = n_sp if mode == "spmv" else n_fu
        if device != "cuda":  # a CPU rehearsal launches nothing
            n = recs[mode]["host_syncs"]
        need(n == recs[mode]["host_syncs"],
             f"query ({mode}): {n} launches for "
             f"{recs[mode]['host_syncs']} vote reads (one launch a read "
             f"while no cap is reached)")
        need(recs[mode]["slowest_lane_launches"] <= n
             < recs[mode]["sum_over_lanes_launches"],
             f"query ({mode}): {n} launches, not between the slowest "
             f"lanes' {recs[mode]['slowest_lane_launches']} and the sum "
             f"{recs[mode]['sum_over_lanes_launches']}")
        need(r.stats["supersteps"].max() < 64, "query: superstep cap hit")
        log(f"phase query_{mode}: {json.dumps(recs[mode])}")
    a, b = batched["spmv"], batched["fused"]
    need(np.array_equal(a.values, b.values, equal_nan=True)
         and np.array_equal(a.final, b.final, equal_nan=True),
         "query: spmv and fused lanes differ")
    for k in ("supersteps", "local_sweeps"):
        need(np.array_equal(a.stats[k], b.stats[k]),
             f"query: {k} differ between spmv and fused")
    one0 = mem["sssp"]["spmv"]
    need(np.array_equal(a.values[0], one0.values, equal_nan=True)
         and np.array_equal(a.stats["supersteps"][0],
                            one0.stats["supersteps"]),
         "query: lane 0 differs from phase 5's source-0 run")

    # every lane alone over the same batch (spmv), timed
    single_s, single_launches = 0.0, 0
    for q, v in enumerate(srcs):
        r, wall, (n_sp, _) = run("spmv", min_plus_program(
            "sssp", init=source_init(v)))
        single_s += wall
        single_launches += n_sp
        for f in ("values", "final"):
            need(np.array_equal(getattr(a, f)[q], getattr(r, f),
                                equal_nan=True),
                 f"query: lane {q} (source {v}) {f} differ from its "
                 f"single-source run")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(a.stats[k][q], r.stats[k]),
                 f"query: lane {q} (source {v}) {k} differ from its "
                 f"single-source run")
    recs["single_source_runs"] = dict(
        runs=Q, seconds=single_s, spmv_launches=single_launches,
        measured="all 32 runs, none projected")
    recs["speedup_over_single_runs"] = {
        m: single_s / recs[m]["seconds"] for m in ("spmv", "fused")}
    log(f"phase query_single: {json.dumps(recs['single_source_runs'])}")
    log(f"phase query_checks: {json.dumps({'sampled_lanes': sampled, 'lanes_checked': Q, 'speedup_over_single_runs': recs['speedup_over_single_runs']})}")
    keep["query"] = {"sources": srcs, "result": a}
    del tiles, btiles
    if device == "cuda":
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 6: the graph path from a GoFS deployment
# ---------------------------------------------------------------------------

def host_rss_gb():
    """(current, peak) resident memory of this process in GB."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    with open("/proc/self/status") as f:
        cur = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return cur * 1024 / 1e9, peak


def check_upload(what, t, dtype):
    """A batch uploaded from the store is what the graph kernels read with
    16-byte loads: contiguous, of the kernels' dtype, its base and every
    outer stride 16-byte aligned."""
    need(t.dtype == dtype, f"{what}: dtype {t.dtype}, want {dtype}")
    need(t.is_contiguous(), f"{what}: not contiguous")
    need(t.data_ptr() % 16 == 0, f"{what}: base not 16-byte aligned")
    es = t.element_size()
    need(all(st * es % 16 == 0 for st, n in zip(t.stride()[:-1],
                                                 t.shape[:-1]) if n > 1),
         f"{what}: strides {t.stride()} x {es} bytes not 16-byte aligned")


def gofs_path(cfg, keep, device="cuda", log=print):
    """Drive the graph path from a GoFS deployment of the collection the
    in-memory path ran (``keep["in_memory"]``), and hold every result
    against that path's.  Returns the phase's records."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.algorithms import pagerank, sssp
    from repro_torch.core.engine import (
        TemporalEngine, min_plus_program, pagerank_program, source_init)
    from repro_torch.gofs import GoFSStore, deploy_collection
    from repro_torch.gofs.layout import tile_map_name
    from repro_torch.gofs.slices import read_array_slice
    from repro_torch.core.semiring import INF

    mem, bg = keep["in_memory"], keep["bg"]
    col, lat, act, eng = mem["col"], mem["lat"], mem["act"], mem["engines"]
    tmpl = col.template
    I, V = len(col), tmpl.num_vertices
    recs = {"cut": {}}  # nothing of the configuration is cut

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def report(name, **kw):
        cur, peak = host_rss_gb()
        recs[name] = dict(kw, host_rss_gb=cur, host_peak_rss_gb=peak)
        log(f"phase gofs_{name}: {json.dumps(recs[name])}")

    def same_run(got, want, what):
        need(np.array_equal(got.values, want.values, equal_nan=True),
             f"{what}: values differ from the in-memory run")
        need(np.array_equal(got.final, want.final, equal_nan=True),
             f"{what}: final differs from the in-memory run")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(got.stats[k], want.stats[k]),
                 f"{what}: {k} differ from the in-memory run")

    root = tempfile.mkdtemp(prefix="gofs_smoke_")
    try:
        # 1. deploy, with latency tile maps and the delta chain
        t0 = time.perf_counter()
        meta = deploy_collection(col, cfg, root,
                                 sparse_absent={"latency": INF})
        deploy_s = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, fs in os.walk(root)
                 for f in fs]
        tm = read_array_slice(os.path.join(root, tile_map_name("latency")))
        report("deploy", seconds=deploy_s, slices=len(files),
               bytes_on_disk=sum(os.path.getsize(f) for f in files),
               instances=meta["num_instances"],
               partitions=meta["num_partitions"],
               instances_per_slice=meta["instances_per_slice"],
               bins_per_partition=meta["bins_per_partition"],
               occupancy=float(tm["occupancy"]),
               delta_unique_ratio=float(tm["delta_unique_ratio"]),
               delta_monotone=int(tm["delta_monotone"]))

        # 2. host iBSP SSSP on the store (the quickstart's step 3)
        store = GoFSStore(root, vertex_projection=(),
                          edge_projection=("latency", "active"))
        t0 = time.perf_counter()
        dists, res = sssp.run_host(store, 0)
        host_s = time.perf_counter() - t0
        d_host = np.full(V, INF)
        for g, d in dists.items():
            d_host[store.get_topology(g).vertices] = d
        ref = mem["sssp_oracle"]
        fin = np.isfinite(ref)
        need(np.array_equal(np.isfinite(d_host), fin),
             "host sssp on GoFS: reachability differs from the oracle")
        need(np.allclose(d_host[fin], ref[fin], rtol=1e-6, atol=0),
             "host sssp on GoFS: distances differ from the oracle beyond "
             "rtol 1e-6")
        cache = store.cache.stats()
        report("host_sssp", seconds=host_s, instances=store.num_timesteps(),
               subgraphs=len(store.subgraph_ids()),
               supersteps=res.stats.supersteps,
               compute_calls=res.stats.compute_calls,
               messages=res.stats.superstep_messages,
               slices_read=store.stats.slices_read,
               bytes_read=store.stats.bytes_read,
               cache_hit_rate=cache["hit_rate"], reached=int(fin.sum()))
        del store, dists

        # 3. dense load into the card (the quickstart's step 5)
        t0 = time.perf_counter()
        tiles, btiles = GoFSStore(root).load_blocked(bg, "latency")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(I):  # one instance's fill at a time
            w = lat[i:i + 1]
            need(np.array_equal(tiles[i], bg.fill_local_batch(w, INF)[0])
                 and np.array_equal(btiles[i],
                                    bg.fill_boundary_batch(w, INF)[0]),
                 f"dense load: instance {i} differs from the in-memory fill")
        check_s = time.perf_counter() - t0
        host_bytes = tiles.nbytes + btiles.nbytes
        sync()
        t0 = time.perf_counter()
        tiles_d = torch.as_tensor(tiles, device=device)
        btiles_d = torch.as_tensor(btiles, device=device)
        sync()
        upload_s = time.perf_counter() - t0
        del tiles, btiles
        check_upload("dense tiles", tiles_d, torch.float32)
        check_upload("dense btiles", btiles_d, torch.float32)
        prog = min_plus_program("sssp", init=source_init(0))
        runs = {}
        for mode in ("spmv", "fused"):
            sync()
            t0 = time.perf_counter()
            r = eng[mode].run(prog, pattern="sequential", tiles=tiles_d,
                              btiles=btiles_d)
            sync()
            runs[mode] = time.perf_counter() - t0
            same_run(r, mem["sssp"][mode], f"sssp from the dense load "
                                           f"({mode})")
            if mode == "spmv":
                dense_store_run = r
        report("dense_load", load_seconds=load_s, check_seconds=check_s,
               upload_seconds=upload_s, host_bytes=host_bytes,
               sssp_seconds=runs,
               supersteps=int(dense_store_run.stats["supersteps"].sum()),
               local_sweeps=int(dense_store_run.stats["local_sweeps"]
                                .sum()))
        del tiles_d, btiles_d
        if device == "cuda":
            torch.cuda.empty_cache()

        # 4. sparse loads, from the delta chain and from the full value
        # slices, one time pack at a time (host memory); sequential SSSP
        # on the delta batches carries its state across the packs
        eng_sp = TemporalEngine(bg, device=device, use_pallas="spmv",
                                layout="sparse")
        ipack = int(meta["instances_per_slice"])
        ts = np.asarray(meta["timestamps"])
        tot = dict(staged_bytes=0, source_bytes=0, pool_read_seconds=0.0,
                   delta_seconds=0.0, full_seconds=0.0, sssp_seconds=0.0,
                   active_tiles=0, template_tiles=0)
        x0, values, counts = None, [], []
        for k in range(-(-I // ipack)):
            lo, hi = k * ipack, min((k + 1) * ipack, I)
            window = (float(ts[lo]), float(ts[hi - 1]) + 1.0)
            t0 = time.perf_counter()
            st = GoFSStore(root, time_range=window)
            need(st.num_timesteps() == hi - lo, f"pack {k}: time filter")
            # the chain's slice, read whole and pinned; then the gather
            need(st.edge_delta_index("latency") is not None,
                 f"pack {k}: no delta chain")
            tot["pool_read_seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            sp_d = st.load_blocked(bg, "latency", layout="sparse")
            tot["delta_seconds"] += time.perf_counter() - t0
            del st  # drops the pinned payload pool
            need(sp_d.source_bytes is not None,
                 f"pack {k}: the delta route was not taken")
            sync()
            t0 = time.perf_counter()
            r = eng_sp.run(prog, pattern="sequential", sparse=sp_d, x0=x0)
            sync()
            tot["sssp_seconds"] += time.perf_counter() - t0
            up = eng_sp._cached_device((sp_d.tiles, sp_d.btiles, sp_d.rows,
                                        sp_d.cols, sp_d.brows, sp_d.bcols))
            for what, t_, dt in zip(
                    ("tiles", "btiles", "rows", "cols", "brows", "bcols"),
                    up[:6], (torch.float32,) * 2 + (torch.int32,) * 4):
                check_upload(f"delta {what}", t_, dt)
            del up
            values.append(r.values)
            counts.append([r.stats["supersteps"], r.stats["local_sweeps"]])
            x0 = bg.scatter_vertex(r.final, INF)
            t0 = time.perf_counter()
            sp_f = GoFSStore(root, time_range=window).load_blocked(
                bg, "latency", layout="sparse", delta=False)
            tot["full_seconds"] += time.perf_counter() - t0
            need(sp_f.source_bytes is None,
                 f"pack {k}: delta=False took the delta route")
            for f in ("tiles", "btiles", "rows", "cols", "brows", "bcols",
                      "nnz", "bnnz"):
                a, b = getattr(sp_d, f), getattr(sp_f, f)
                need(a.dtype == b.dtype and a.shape == b.shape
                     and all(np.array_equal(a[i], b[i])
                             for i in range(len(a))),
                     f"pack {k}: delta and full loads differ in {f}")
            tot["staged_bytes"] += sp_d.staged_bytes()
            tot["source_bytes"] += sp_d.source_bytes
            tot["active_tiles"] += int(sp_d.nnz.sum() + sp_d.bnnz.sum())
            tot["template_tiles"] += (hi - lo) * (sp_d.total_tiles
                                                  + sp_d.total_btiles)
            del sp_d, sp_f
        need(np.array_equal(np.concatenate(values), dense_store_run.values,
                            equal_nan=True),
             "sssp from the delta batches differs from the dense store run")
        for j, k in enumerate(("supersteps", "local_sweeps")):
            need(np.array_equal(np.concatenate([c[j] for c in counts]),
                                dense_store_run.stats[k]),
                 f"sssp from the delta batches: {k} differ from the dense "
                 f"store run")
        del eng_sp
        if device == "cuda":
            torch.cuda.empty_cache()
        report("sparse_load", packs=-(-I // ipack), **tot,
               occupancy=tot["active_tiles"] / max(1, tot["template_tiles"]),
               source_over_staged=tot["source_bytes"] / tot["staged_bytes"])

        # 5. PageRank from the store's activity
        t0 = time.perf_counter()
        a_store = GoFSStore(root).edge_attr_matrix(pagerank.ACTIVE_ATTR)
        need(np.array_equal(a_store, act), "active: store != in-memory")
        w = pagerank.edge_weights_for_instances(tmpl.src, a_store, V)
        tiles_d, btiles_d = eng["spmv"].stage(w, 0.0)
        sync()
        stage_s = time.perf_counter() - t0
        pr = pagerank_program(V, iters=10)
        used, store_pr = {}, {}
        for mode in ("spmv", "fused"):
            r = eng[mode].run(pr, pattern="independent", tiles=tiles_d,
                              btiles=btiles_d)
            store_pr[mode] = r
            need(bool(np.isfinite(r.values).all()),
                 f"pagerank from GoFS ({mode}): non-finite ranks")
            want = torch.from_numpy(mem["pagerank"][mode].values)
            err = (torch.from_numpy(r.values) - want).abs()
            used[mode] = float((err / plus_mul_limit(want)).max())
            need(used[mode] <= 1.0, f"pagerank from GoFS ({mode}): "
                                    f"{used[mode]:.3g}x the limit from the "
                                    f"in-memory run")
        del tiles_d, btiles_d
        if device == "cuda":
            torch.cuda.empty_cache()
        report("pagerank", stage_seconds=stage_s, limit_used=used)

        # 6. the Gopher session on the same deployment
        recs["session"] = session_phase(
            root, tmpl, want={"spmv": dense_store_run,
                              "fused": mem["sssp"]["fused"],
                              "pagerank": store_pr["spmv"],
                              "query": keep["query"]},
            device=device, log=log)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return recs


class PeakRSS:
    """Sample this process's resident memory on a thread while the block
    runs; ``peak_gb`` is the largest reading."""

    def __enter__(self):
        import threading

        self.peak_gb = host_rss_gb()[0]
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.wait(0.1):
            self.peak_gb = max(self.peak_gb, host_rss_gb()[0])

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak_gb = max(self.peak_gb, host_rss_gb()[0])


def session_phase(root, tmpl, want, device="cuda", log=print):
    """The Gopher session on the GoFS deployment at full width and depth
    (``GopherSession(store).plan/run/run_many``), held against phase 6's
    explicit engine runs in ``want``: SSSP bitwise in both kernel modes
    and on the streamed delta route, PageRank within
    :func:`plus_mul_limit`, N-hop's histograms equal to the oracle's.
    Then the query axis through the session: SSSP with the query phase's
    32 sources streamed from the store, every lane bitwise equal to the
    query phase's in-memory lanes (``want["query"]``) and lane 0 to step
    1; N-hop with 4 sources, lane 0 equal to step 3's single-source
    histograms and the others to ``nhop.oracle`` on the first and last
    instance; ``tracking`` of the plate seen in the most timesteps, its
    trace equal to the host iBSP ``tracking.run_host`` on the store.
    The graph kernels' launches on this path are counted by call shape on
    their own.  Returns the phase's records."""
    import numpy as np
    import torch

    from repro_torch.core.algorithms import nhop, tracking
    from repro_torch.gofs import GoFSStore
    from repro_torch.gofs.prefetch import pinned_ring, release_pinned
    from repro_torch.gopher import GopherSession
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda

    cuda = device == "cuda"  # a CPU rehearsal checks control flow only
    kernels = (spmv_blocked_cuda, fused_step_cuda)
    outer = [k.launches for k in kernels]
    for k in kernels:
        k.launches = 0
    recs = {}
    if cuda:
        free, total = torch.cuda.mem_get_info()
        recs.update(device_free_gb_before=free / 1e9,
                    device_total_gb=total / 1e9)
    log(f"phase session_setup: {json.dumps(recs)}")

    def same(got, ref, what):
        need(np.array_equal(got.values, ref.values, equal_nan=True),
             f"session {what}: values differ from phase 6")
        need(np.array_equal(got.final, ref.final, equal_nan=True),
             f"session {what}: final differs from phase 6")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(got.stats[k], ref.stats[k]),
                 f"session {what}: {k} differ from phase 6")

    def step(name, sess, fn):
        """Run ``fn`` with the session's engines' stream reports and the
        peaks fresh (the pinned ring keeps its buffers from step to step,
        as across any two passes); log and return its records."""
        if cuda:
            ring = pinned_ring(device)
            ring.peak_bytes, ring.pin_seconds = ring.pinned_bytes, 0.0
            torch.cuda.reset_peak_memory_stats()
        for e in sess._engines.values():
            e.last_stream_report = None
        t0 = time.perf_counter()
        with PeakRSS() as rss:
            out = fn()
        wall = time.perf_counter() - t0
        rec = dict(seconds=wall, report=dict(sess.last_run_report),
                   stream={"/".join(k): e.last_stream_report
                           for k, e in sess._engines.items()
                           if e.last_stream_report is not None},
                   host_peak_rss_gb=rss.peak_gb)
        if cuda:
            rec.update(peak_pinned_bytes=ring.peak_bytes,
                       pin_seconds=ring.pin_seconds,
                       peak_device_gb=torch.cuda.max_memory_allocated()
                       / 1e9)
        recs[name] = rec
        log(f"phase session_{name}: {json.dumps(rec)}")
        return out

    V, I = tmpl.num_vertices, len(want["spmv"].values)
    try:
        with call_shapes() as shapes:
            t0 = time.perf_counter()
            sess = GopherSession(GoFSStore(root), device=device)
            recs["open_seconds"] = time.perf_counter() - t0

            # 1. the auto plan: dense, dense comm, async, no delta, cold
            plan = sess.plan("sssp", source=0)
            got = {k: getattr(plan, k).value for k in (
                "layout", "comm", "staging", "delta", "warm", "kernel",
                "placement")}
            recs["plan"] = dict(got, occupancy=plan.estimate_dict[
                "occupancy"])
            need(not cuda or recs["plan"] == {
                "layout": "dense", "comm": "dense", "staging": "async",
                "delta": False, "warm": False, "kernel": "spmv",
                "placement": "stacked", "occupancy": 1.0},
                f"session plan: {recs['plan']}")
            log("session plan:\n" + plan.explain())
            r1 = step("sssp_spmv", sess, lambda: sess.run(plan))
            same(r1.engine, want["spmv"], "sssp (spmv)")

            # 2. the same plan in fused mode
            plan_f = sess.plan("sssp", source=0, kernel="fused")
            r2 = step("sssp_fused", sess, lambda: sess.run(plan_f))
            same(r2.engine, want["fused"], "sssp (fused)")

            # 3. three analytics in one run_many
            plans = [plan, sess.plan("nhop", source=0, n_hops=4),
                     sess.plan("pagerank", iters=10)]
            many = step("run_many", sess, lambda: sess.run_many(plans))
            same(many[0].engine, r1.engine, "run_many sssp")
            ranks = torch.from_numpy(many[2].output["ranks"])
            ref = torch.from_numpy(want["pagerank"].values)
            need(bool(torch.isfinite(ranks).all()),
                 "session pagerank: non-finite ranks")
            used = float(((ranks - ref).abs() / plus_mul_limit(ref)).max())
            need(used <= 1.0, f"session pagerank: {used:.3g}x the limit "
                              f"from phase 6's store PageRank")
            t0 = time.perf_counter()
            lat = GoFSStore(root).edge_attr_matrix("latency")
            hists = many[1].output["histograms"]
            need(hists.shape[0] == I, "session nhop: histogram count")
            for i in range(I):
                need(np.array_equal(hists[i], nhop.oracle(
                    tmpl.src, tmpl.dst, lat[i], V, 0, n_hops=4)),
                    f"session nhop: instance {i}'s histogram differs "
                    f"from nhop.oracle")
            checks = dict(
                open_seconds=recs["open_seconds"],
                pagerank_limit_used=used,
                nhop_composite=[int(x) for x in many[1].output["composite"]],
                nhop_oracle_seconds=time.perf_counter() - t0)
            recs["run_many"].update(checks)
            log(f"phase session_checks: {json.dumps(checks)}")
            nhop0 = many[1].output["histograms"]
            del many, sess
            if cuda:
                torch.cuda.empty_cache()

            # 4. the sparse override: the streamed delta route, fused
            sess = GopherSession(GoFSStore(root), device=device)
            plan_d = sess.plan("sssp", source=0, layout="sparse",
                               kernel="fused")
            need(not cuda or (plan_d.delta.value is True
                              and plan_d.staging.value == "async"),
                 "session sparse plan: not the streamed delta route")
            r4 = step("sssp_delta_fused", sess, lambda: sess.run(plan_d))
            same(r4.engine, r1.engine, "sssp (sparse delta, fused)")
            st = recs["sssp_delta_fused"]
            up = sum(v["uploaded_bytes"] for v in st["stream"].values())
            st.update(source_bytes=st["report"]["staged_bytes"],
                      staged_bytes=up,
                      occupancy=r4.engine.occupancy)
            log(f"phase session_delta_bytes: source {st['source_bytes']} "
                f"staged {up}")
            del sess
            if cuda:
                torch.cuda.empty_cache()

            # 5. the query axis: SSSP with 32 sources, streamed
            sess = GopherSession(GoFSStore(root), device=device)
            srcs, qref = want["query"]["sources"], want["query"]["result"]
            plan_q = sess.plan("sssp", source=srcs)
            need(plan_q.estimate_dict["n_sources"] == len(srcs),
                 "session query plan: n_sources")
            need(not cuda or plan_q.staging.value == "async",
                 "session query plan: not streamed")
            r5 = step("sssp_q32", sess, lambda: sess.run(plan_q))
            need(r5.output["final"].shape == (len(srcs), V),
                 "session sssp (32 sources): final shape")
            same(r5.engine, qref, "sssp (32 sources)")
            for f in ("values", "final"):
                need(np.array_equal(getattr(r5.engine, f)[0],
                                    getattr(r1.engine, f), equal_nan=True),
                     f"session sssp (32 sources): lane 0 {f} differ from "
                     f"step 1")

            # 6. N-hop with 4 sources
            n_src = srcs[:4]
            r6 = step("nhop_q4", sess, lambda: sess.run(sess.plan(
                "nhop", source=n_src, n_hops=4)))
            hq = r6.output["histograms"]
            need(hq.shape[:2] == (4, I), "session nhop (4 sources): shape")
            need(np.array_equal(hq[0], nhop0),
                 "session nhop (4 sources): lane 0 differs from step 3")
            t0 = time.perf_counter()
            for q in range(1, 4):
                for i in (0, I - 1):
                    need(np.array_equal(hq[q, i], nhop.oracle(
                        tmpl.src, tmpl.dst, lat[i], V, n_src[q],
                        n_hops=4)),
                        f"session nhop: lane {q} instance {i} differs "
                        f"from nhop.oracle")
            recs["nhop_q4"]["oracle_seconds"] = time.perf_counter() - t0

            # 7. tracking of one plate, against host iBSP on the store
            plates = GoFSStore(root).vertex_attr_matrix(
                tracking.PLATE_ATTR)
            ids, seen = np.unique(
                [p for t in range(I) for p in np.unique(plates[t])
                 if p >= 0], return_counts=True)
            plate = int(ids[np.argmax(seen)])
            start = int(np.argwhere(plates == plate)[0][1])
            r7 = step("tracking", sess, lambda: sess.run(sess.plan(
                "tracking", plate=plate, initial_vertex=start)))
            t0 = time.perf_counter()
            host_trace, hres = tracking.run_host(
                GoFSStore(root, vertex_projection=(tracking.PLATE_ATTR,),
                          edge_projection=()), plate, start)
            host_s = time.perf_counter() - t0
            trace = r7.output["trace"]
            need(trace == host_trace,
                 f"session tracking: trace differs from host iBSP "
                 f"({len(trace)} vs {len(host_trace)} sightings)")
            need(len(trace) > 1, "session tracking: no trail to follow")
            recs["tracking"].update(
                plate=plate, initial_vertex=start, sightings=len(trace),
                timesteps_seen=int(seen.max()),
                host_ibsp_seconds=host_s,
                host_ibsp_compute_calls=hres.stats.compute_calls,
                host_ibsp_supersteps=hres.stats.supersteps)
            log(f"phase session_tracking_check: plate {plate} from "
                f"{start}: {len(trace)} sightings, host iBSP {host_s:.1f} s")
            del sess
            if cuda:
                torch.cuda.empty_cache()
        launches = {k.__name__: k.launches for k in kernels}
    finally:
        release_pinned()
        for k, n in zip(kernels, outer):
            k.launches += n
    recs["launches"] = launches
    recs["launches_by_call_shape"] = {
        f"{k} {c}": n for (k, c), n in sorted(shapes.items())}
    log(f"session launches: {json.dumps(launches)}")
    log("session launches by call shape: "
        + json.dumps(recs["launches_by_call_shape"]))
    for name, v in launches.items():
        need(sum(n for (k, _), n in shapes.items() if k == name) == v,
             f"{name}: session launches by call shape do not sum to {v}")
        need(not cuda or v > 0,
             f"{name} was not launched on the session path")
    return recs


# ---------------------------------------------------------------------------
# phase 7: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20, warm=3, graph=True) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls.
    ``graph=True`` captures the calls in one CUDA graph and times its
    replay: device time alone.  ``graph=False`` times eager calls, which
    also counts the time the card waits for the host to launch."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


FLUSH_BYTES = 256 << 20  # read between cold calls: five times the L2


def cold_ms(fn, reps=20) -> float:
    """Device milliseconds per call of ``fn`` with its inputs out of L2: a
    FLUSH_BYTES read before each call, the pairs replayed from one CUDA
    graph, less the reads alone.  A decode step's attention finds its
    layer's K/V so, after the other layers' reads; back-to-back replays
    (:func:`cuda_ms`) of a 33.6 MB cache read much of it from the 50 MB
    L2."""
    import torch

    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    total = torch.empty((), device="cuda")

    def read():
        torch.sum(flush, dim=0, out=total)

    def read_then_call():
        read()
        fn()

    return cuda_ms(read_then_call, reps) - cuda_ms(read, reps)


def dense_operator(tiles, rows, cols, nvb_out, nvb_in):
    """(P, nvb_out*B, nvb_in*B) dense matrix of the blocked operator
    y = A^T x (block (c, r) = W^T) — the library call's input, built
    outside any timing."""
    import torch

    P, T, B, _ = tiles.shape
    m = torch.zeros((P, nvb_out, nvb_in, B, B), dtype=tiles.dtype,
                    device=tiles.device)
    p, t = torch.nonzero(cols >= 0, as_tuple=True)
    m[p, cols[p, t].long(), rows[p, t].long()] = \
        tiles[p, t].transpose(-1, -2)
    return m.permute(0, 1, 3, 2, 4).reshape(P, nvb_out * B, nvb_in * B)


def kernel_report(keep, launches, shape_launches, query_launches, card,
                  rate):
    """One JSON record per kernel: the top-level numbers are its hot
    main-path call (the min-plus local sweep of the SSSP fixpoint); every
    main-path call shape is listed under ``calls``, with its launches on
    the main path (``shape_launches``, from :func:`call_shapes`), and then
    the Q-lane form of each call shape at Q in QUERY_SWEEP (held against
    plain, timed, with ``torch.bmm`` over the lanes as the plus-mul
    library call), with its launches on the query path
    (``query_launches``), a skewed control at Q = 32, and wrong controls
    that must fail the comparison.  ``q_lanes`` summarises the Q = 32
    calls."""
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.core.superstep import _publish
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    bg, eng = keep["bg"], keep["eng"]
    rows, cols, brows, bcols = eng._index
    plan, bplan = eng._plans["plan"], eng._plans["bplan"]
    vmask = eng._tail[3]
    P, Vp, B = bg.n_parts, bg.vp, bg.block_size
    nvb, nbb = Vp // B, bg.num_boundary // B
    dg_like = eng._device_graph(keep["sssp_tiles"], keep["sssp_btiles"],
                                eng._index)
    x_mp = keep["x_sssp"]
    b_mp = _publish(x_mp, dg_like, MIN_PLUS, eng.comm)
    x_pm = keep["x_pr"]
    b_pm = _publish(x_pm, dg_like, PLUS_MUL, eng.comm)
    n_local = int((cols >= 0).sum())
    n_bound = int((bcols >= 0).sum())
    tile_b = B * B * 4

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    calls = {"spmv_blocked_cuda": [], "fused_step_cuda": []}

    def record(kernel, name, sr, kfn, pfn, lfn, moved, pairs, lanes=None):
        """Hold ``kfn`` against ``pfn`` (and ``lfn``, the library call,
        where there is one) and time all three.  ``moved``: the bytes the
        call must move; ``pairs``: its multiply-add (add-min) pairs, one
        FP32 instruction each for plus-mul (FMA), two for min-plus (add,
        min).  ``lanes``: Q of a Q-lane call, whose launches are the query
        path's."""
        wrapper = spmv_blocked_cuda if kernel == "spmv_blocked_cuda" \
            else fused_step_cuda
        before = dict(wrapper.launches_by_walk)
        kout, pout = kfn(), pfn()
        walk = [w for w, n in wrapper.launches_by_walk.items()
                if n > before[w]]
        need(len(walk) == 1, f"{name}: launched walks {walk}")
        if isinstance(kout, tuple):
            kc, pc = kout[1], pout[1]
            need((kc is None and pc is None) or torch.equal(kc, pc),
                 f"{name}: votes differ")
            kout, pout = kout[0], pout[0]
        err, used = compare(kout, pout, sr.name, name)
        if lfn is not None:  # the yardstick computes the same function
            compare(lfn().reshape(pout.shape), pout, sr.name,
                    name + " library call")
        instr = pairs * (2 if sr is MIN_PLUS else 1)
        t_bytes, t_ops = moved / rate, instr / FP32_ISSUE
        src = shape_launches if lanes is None else query_launches
        rec = {
            "call": name, "semiring": sr.name,
            "launches": src.get((kernel, name), 0),
            "ms": cuda_ms(kfn), "eager_ms": cuda_ms(kfn, graph=False),
            "plain_ms": cuda_ms(pfn),
            "library_ms": None if lfn is None else cuda_ms(lfn),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "issue_ms": t_ops * 1e3,
            "bytes": moved, "instructions": instr,
            "max_abs_err": err, "limit_used": used,
            "max_abs_plain": float(pout.abs().max()), "walk": walk[0],
        }
        if lanes is not None:
            rec["lanes"] = lanes
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        calls[kernel].append(rec)

    # -- spmv: local sweep and consume, both semirings --------------------
    for sr, x, bnd, tl, btl in (
            (MIN_PLUS, x_mp, b_mp, keep["sssp_tiles"], keep["sssp_btiles"]),
            (PLUS_MUL, x_pm, b_pm, keep["pr_tiles"], keep["pr_btiles"])):
        lib_local = lib_bound = None
        if sr is PLUS_MUL:
            a_loc = dense_operator(tl, rows, cols, nvb, nvb)
            a_bnd = dense_operator(btl, brows, bcols, nvb, nbb)
            xs, bs = x[..., None], bnd[None, :, None]
            lib_local = lambda: torch.bmm(a_loc, xs)  # noqa: E731
            lib_bound = lambda: torch.matmul(a_bnd, bs)  # noqa: E731
        moved = n_local * tile_b + nbytes(rows, cols, x) + P * Vp * 4
        record("spmv_blocked_cuda", f"local sweep {sr.name}", sr,
               lambda: spmv_blocked_cuda(tl, rows, cols, x, sr, plan=plan),
               lambda: spmv_blocked_ref(tl, rows, cols, x, sr),
               lib_local, moved, n_local * B * B)
        moved = (n_bound * tile_b + nbytes(brows, bcols, bnd) + P * Vp * 4)
        record("spmv_blocked_cuda", f"consume {sr.name}", sr,
               lambda: spmv_blocked_cuda(btl, brows, bcols, bnd[None], sr,
                                         n_out_blocks=nvb, plan=bplan),
               lambda: spmv_blocked_ref(btl, brows, bcols, bnd[None], sr,
                                        n_out_blocks=nvb),
               lib_bound, moved, n_bound * B * B)

        # -- fused: the main path's call shapes -------------------------
        # SSSP sweeps and consumes with the combine and the vote; PageRank
        # takes neither (superstep._spmv_only, superstep._consume)
        xs3 = x.reshape(P, nvb, B)
        vm3 = vmask.reshape(P, nvb, B)
        b3 = bnd.reshape(1, nbb, B)
        if sr is MIN_PLUS:
            shapes = {"sweep": (tl, rows, cols, xs3, xs3, xs3, None),
                      "consume": (btl, brows, bcols, b3, xs3,
                                  torch.flip(xs3, (2,)).contiguous(), None)}
        else:
            shapes = {"spmv": (tl, rows, cols, xs3, None, None, a_loc),
                      "consume": (btl, brows, bcols, b3, None, None, a_bnd)}
        for name, (tt, rr, cc, xin, comb, xref, a) in shapes.items():
            n_t = n_local if tt is tl else n_bound
            pl = plan if tt is tl else bplan
            vm = None if xref is None else vm3
            lfn = None
            if a is not None:  # plus-mul, no combine
                xin_v = xin.reshape(xin.shape[0], -1, 1)
                lfn = (lambda a=a, xin_v=xin_v:
                       torch.bmm(a, xin_v.expand(P, -1, -1)))
            # x_out written; x_comb, x_ref, the mask and the votes where used
            states = nbytes(xs3) + sum(
                nbytes(t_) for t_ in (comb, xref, vm) if t_ is not None) + (
                P * 4 if xref is not None else 0)
            moved = n_t * tile_b + nbytes(rr, cc, xin) + states
            record("fused_step_cuda", f"{name} {sr.name}", sr,
                   lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                   xref=xref, vm=vm, pl=pl: fused_step_cuda(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb,
                       plan=pl),
                   lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                   xref=xref, vm=vm: fused_step_ref(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb),
                   lfn, moved, n_t * B * B)

    # skewed control: partition 0's boundary runs gathered into one output
    # block, so one run holds all its tiles (the walk plan spreads it over
    # many CTAs); min-plus, held against plain and timed like the rest
    skew = bcols.clone()
    skew[0][skew[0] >= 0] = 0
    splan = to_device(walk_plan(skew.cpu().numpy(), nvb,
                                chunk=default_chunk(B)), skew.device)
    btl, b3 = keep["sssp_btiles"], b_mp.reshape(1, nbb, B)
    xs3 = x_mp.reshape(P, nvb, B)
    xref = torch.flip(xs3, (2,)).contiguous()
    vm3 = vmask.reshape(P, nvb, B)
    name = "consume min_plus, skewed control (partition 0 in one block)"
    record("spmv_blocked_cuda", name, MIN_PLUS,
           lambda: spmv_blocked_cuda(btl, brows, skew, b_mp[None], MIN_PLUS,
                                     n_out_blocks=nvb, plan=splan),
           lambda: spmv_blocked_ref(btl, brows, skew, b_mp[None], MIN_PLUS,
                                    n_out_blocks=nvb),
           None, n_bound * tile_b + nbytes(brows, skew, b_mp) + P * Vp * 4,
           n_bound * B * B)
    record("fused_step_cuda", name, MIN_PLUS,
           lambda: fused_step_cuda(btl, brows, skew, b3, xs3, xref, vm3,
                                   MIN_PLUS, plan=splan),
           lambda: fused_step_ref(btl, brows, skew, b3, xs3, xref, vm3,
                                  MIN_PLUS),
           None, n_bound * tile_b + nbytes(brows, skew, b3, xs3, xs3, xref,
                                           vm3) + P * 4,
           n_bound * B * B)

    # -- the query axis: each call shape with Q lanes ---------------------
    gen = torch.Generator(device=x_mp.device).manual_seed(7)

    def lanes_of(x, Q, sr):
        """Q states near ``x``: lane 0 is x, the others moved by up to
        one unit (min-plus) or ten percent (plus-mul); inf stays inf."""
        u = torch.rand((Q,) + tuple(x.shape), generator=gen,
                       device=x.device)
        u[0] = 0
        return x + u if sr is MIN_PLUS else x * (1 + 0.1 * u)

    def bmm_lanes(a, xin, Q):
        """The library call of a plus-mul Q-lane call: ``torch.bmm`` of
        the dense operator with the Q lanes as columns."""
        xcol = xin.reshape(Q, xin.shape[1], -1).permute(1, 2, 0)
        xcol = xcol.expand(P, -1, -1)
        return lambda: torch.bmm(a, xcol).permute(2, 0, 1)

    controls = []

    def must_fail(what, fn):
        try:
            fn()
        except SmokeFailure as e:
            controls.append({"control": what, "failed": True,
                             "message": str(e)[:160]})
            return
        raise SmokeFailure(f"wrong control passed: {what}")

    q_states = {}
    for sr, x, tl, btl in (
            (MIN_PLUS, x_mp, keep["sssp_tiles"], keep["sssp_btiles"]),
            (PLUS_MUL, x_pm, keep["pr_tiles"], keep["pr_btiles"])):
        if sr is PLUS_MUL:
            a_loc = dense_operator(tl, rows, cols, nvb, nvb)
            a_bnd = dense_operator(btl, brows, bcols, nvb, nbb)
        for Q in QUERY_SWEEP:
            xq = lanes_of(x, Q, sr)
            bq = _publish(xq, dg_like, sr, eng.comm)  # (Q, NB)
            q_states[(sr.name, Q)] = (xq, bq)
            xin_b = bq.reshape(Q, 1, -1)
            sfx = f" {sr.name} Q={Q}"
            # spmv: local sweep and consume
            for name, tt, rr, cc, xin, pl, n_t, a in (
                    ("local sweep", tl, rows, cols, xq, plan, n_local,
                     None if sr is MIN_PLUS else a_loc),
                    ("consume", btl, brows, bcols, xin_b, bplan, n_bound,
                     None if sr is MIN_PLUS else a_bnd)):
                lfn = None if a is None else bmm_lanes(a, xin, Q)
                moved = (n_t * tile_b + nbytes(rr, cc, xin)
                         + Q * P * Vp * 4)
                record("spmv_blocked_cuda", name + sfx, sr,
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, pl=pl:
                       spmv_blocked_cuda(tt, rr, cc, xin, sr,
                                         n_out_blocks=nvb, plan=pl),
                       lambda tt=tt, rr=rr, cc=cc, xin=xin:
                       spmv_blocked_ref(tt, rr, cc, xin, sr,
                                        n_out_blocks=nvb),
                       lfn, moved, n_t * B * B * Q, lanes=Q)
            # fused: the engine's shapes (SSSP: combine and vote; PageRank:
            # neither)
            xs4 = xq.reshape(Q, P, nvb, B)
            b4 = bq.reshape(Q, 1, nbb, B)
            vm3 = vmask.reshape(P, nvb, B)
            if sr is MIN_PLUS:
                fshapes = {"sweep": (tl, rows, cols, xs4, xs4, xs4, plan),
                           "consume": (btl, brows, bcols, b4, xs4,
                                       torch.flip(xs4, (3,)).contiguous(),
                                       bplan)}
            else:
                fshapes = {"spmv": (tl, rows, cols, xs4, None, None, plan),
                           "consume": (btl, brows, bcols, b4, None, None,
                                       bplan)}
            for name, (tt, rr, cc, xin, comb, xref, pl) in fshapes.items():
                n_t = n_local if tt is tl else n_bound
                vm = None if xref is None else vm3
                states = nbytes(xs4) + sum(
                    nbytes(t_) for t_ in (comb, xref, vm) if t_ is not None
                ) + (Q * P * 4 if xref is not None else 0)
                lfn = None if sr is MIN_PLUS else bmm_lanes(
                    a_loc if tt is tl else a_bnd, xin, Q)
                record("fused_step_cuda", name + sfx, sr,
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm, pl=pl: fused_step_cuda(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb, plan=pl),
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm: fused_step_ref(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb),
                       lfn, n_t * tile_b + nbytes(rr, cc, xin) + states,
                       n_t * B * B * Q, lanes=Q)

    # skewed control at Q = 32 (min-plus): the boundary runs of partition
    # 0 in one output block
    Q = QUERY_SWEEP[-1]
    btl = keep["sssp_btiles"]
    xq, bq = q_states[("min_plus", Q)]
    xs4, b4 = xq.reshape(Q, P, nvb, B), bq.reshape(Q, 1, nbb, B)
    xref4 = torch.flip(xs4, (3,)).contiguous()
    vm3 = vmask.reshape(P, nvb, B)
    name = f"consume min_plus Q={Q}, skewed control (partition 0 in one block)"
    record("spmv_blocked_cuda", name, MIN_PLUS,
           lambda: spmv_blocked_cuda(btl, brows, skew, bq[:, None], MIN_PLUS,
                                     n_out_blocks=nvb, plan=splan),
           lambda: spmv_blocked_ref(btl, brows, skew, bq[:, None], MIN_PLUS,
                                    n_out_blocks=nvb),
           None, n_bound * tile_b + nbytes(brows, skew, bq) + Q * P * Vp * 4,
           n_bound * B * B * Q, lanes=Q)
    record("fused_step_cuda", name, MIN_PLUS,
           lambda: fused_step_cuda(btl, brows, skew, b4, xs4, xref4, vm3,
                                   MIN_PLUS, plan=splan),
           lambda: fused_step_ref(btl, brows, skew, b4, xs4, xref4, vm3,
                                  MIN_PLUS),
           None, n_bound * tile_b + nbytes(brows, skew, b4, xs4, xs4, xref4,
                                           vm3) + Q * P * 4,
           n_bound * B * B * Q, lanes=Q)

    # signed zeros, infinities and NaN through the lane walk (min-plus,
    # Q = 20 and 32, the main path's local sweep and consume): tiles with
    # a third of their weights +0 or -0, one -inf and one NaN weight;
    # lanes of signed zeros, lanes with NaN and lanes with -inf; held
    # against the plain version (same_bits) and, lane by lane, against
    # the one-lane kernel (bit for bit, NaN included)
    sgen = torch.Generator(device=x_mp.device).manual_seed(19)

    def signed_zero_tiles(t):
        t = t.clone()
        pick = torch.isfinite(t) & (torch.rand(t.shape, generator=sgen,
                                               device=t.device) < 0.33)
        sign = torch.rand(t.shape, generator=sgen, device=t.device) < 0.5
        t[pick] = torch.where(sign, -0.0, 0.0)[pick]
        nz = torch.nonzero(torch.isfinite(t[0]))
        t[0][tuple(nz[0])] = float("-inf")
        t[0][tuple(nz[-1])] = float("nan")
        return t

    def special_lanes(x):
        x = x.clone()
        sign = torch.rand(x[1::4].shape, generator=sgen,
                          device=x.device) < 0.5
        x[1::4] = torch.where(sign, -0.0, 0.0)
        x[2::4, ..., 3::7] = float("nan")
        x[3::4, ..., 5::11] = float("-inf")
        return x

    ztl = signed_zero_tiles(keep["sssp_tiles"])
    zbtl = signed_zero_tiles(keep["sssp_btiles"])
    special = []
    for Q in (20, QUERY_SWEEP[-1]):
        xq, bq = q_states[("min_plus", Q)]
        xq, bq = special_lanes(xq), special_lanes(bq)
        xs4, b4 = xq.reshape(Q, P, nvb, B), bq.reshape(Q, 1, nbb, B)
        xref4 = torch.flip(xs4, (3,)).contiguous()
        vm3 = vmask.reshape(P, nvb, B)
        n0 = walk_counts()
        for name, kfn, pfn, one in (
                ("local sweep",
                 lambda: spmv_blocked_cuda(ztl, rows, cols, xq, MIN_PLUS,
                                           plan=plan),
                 lambda: spmv_blocked_ref(ztl, rows, cols, xq, MIN_PLUS),
                 lambda q: spmv_blocked_cuda(ztl, rows, cols, xq[q],
                                             MIN_PLUS, plan=plan)),
                ("consume",
                 lambda: fused_step_cuda(zbtl, brows, bcols, b4, xs4, xref4,
                                         vm3, MIN_PLUS, plan=bplan),
                 lambda: fused_step_ref(zbtl, brows, bcols, b4, xs4, xref4,
                                        vm3, MIN_PLUS),
                 lambda q: fused_step_cuda(zbtl, brows, bcols, b4[q], xs4[q],
                                           xref4[q], vm3, MIN_PLUS,
                                           plan=bplan))):
            what = f"{name} min_plus Q={Q}, ±0/±inf/NaN control"
            k, p_ = kfn(), pfn()
            if isinstance(k, tuple):
                need(torch.equal(k[1], p_[1]), f"{what}: votes differ")
                k, p_ = k[0], p_[0]
            same_bits(k, p_, what)
            lanes_checked = sorted({0, 1, 2, 3, Q - 1})
            for q in lanes_checked:
                o = one(q)
                o = o[0] if isinstance(o, tuple) else o
                need(torch.equal(k[q].view(torch.int32),
                                 o.view(torch.int32)),
                     f"{what}: lane {q} differs from the one-lane kernel")
            special.append({"control": what, "passed": True,
                            "signed_zero_outputs": int(
                                ((p_ == 0) & torch.signbit(p_)).sum()),
                            "nan_outputs": int(torch.isnan(p_).sum()),
                            "lanes_vs_one_lane": lanes_checked})
        by_walk = {kk: v["lane_walk"] - n0[kk]["lane_walk"]
                   for kk, v in walk_counts().items()}
        need(by_walk == {"spmv_blocked_cuda": 1, "fused_step_cuda": 1},
             f"signed-zero controls at Q={Q}: lane-walk launches {by_walk}")
    # the two-tile control: one output block, x = -0 at both tiles' rows,
    # weights +0 in one tile and -0 in the other, both orders, chunks of
    # one tile (the two meet in the run's combine): -0 at every output on
    # every walk
    for Q in (1, 4, 8, QUERY_SWEEP[-1]):
        for rev in (False, True):
            tt = torch.stack([torch.zeros(B, B), torch.full((B, B), -0.0)])
            rr = torch.tensor([0, 1], dtype=torch.int32)
            if rev:
                tt, rr = tt.flip(0), rr.flip(0)
            tt, rr = tt[None].contiguous().cuda(), rr[None].contiguous().cuda()
            cc = torch.zeros_like(rr)
            tplan = to_device(walk_plan(cc.cpu().numpy(), 1, chunk=1), "cuda")
            xz = torch.full((Q, 1, 2 * B), -0.0, device="cuda")
            y = spmv_blocked_cuda(tt, rr, cc, xz, MIN_PLUS, n_out_blocks=1,
                                  plan=tplan)
            need(bool(((y == 0) & torch.signbit(y)).all()),
                 f"two-tile ±0 control Q={Q} reverse={rev}: not -0")
    special.append({"control": "two-tile ±0, Q 1, 4, 8, 32, both orders",
                    "passed": True})
    # the plain folds on the card: MIN_PLUS.add is torch's CUDA minimum,
    # its reductions repaired; -0 wherever a -0 meets +0, both orders
    for n in (2, 100000):
        zz = torch.zeros(n, device="cuda")
        zz[n // 2:] = -0.0
        for t in (zz, zz.flip(0)):
            outs = (MIN_PLUS.add(t[:1].expand(n), t), MIN_PLUS.add(t, t.flip(0)),
                    MIN_PLUS.add_reduce(t, 0), MIN_PLUS.segment_reduce(
                        t, torch.zeros(n, dtype=torch.long, device="cuda"), 1),
                    MIN_PLUS.scatter_add(
                        torch.full((1,), float("inf"), device="cuda"),
                        torch.zeros(n, dtype=torch.long, device="cuda"), t))
            need(all(bool((o == 0).all()) for o in outs)
                 and bool(torch.signbit(outs[1]).all())
                 and all(bool(torch.signbit(o).all()) for o in outs[2:]),
                 f"MIN_PLUS folds on the card: a -0 lost (n={n})")
    special.append({"control": "MIN_PLUS add, add_reduce, segment_reduce, "
                    "scatter_add on the card, ±0 both orders",
                    "passed": True})
    print("signed-zero controls: " + json.dumps(special))

    # wrong controls: the Q-lane outputs against the plain version's with
    # the lanes rolled by one, and (plus-mul) with one tile dropped
    for sr, tl in ((MIN_PLUS, keep["sssp_tiles"]), (PLUS_MUL,
                                                   keep["pr_tiles"])):
        xq, _ = q_states[(sr.name, Q)]
        k = spmv_blocked_cuda(tl, rows, cols, xq, sr, plan=plan)
        p_ = spmv_blocked_ref(tl, rows, cols, xq, sr)
        compare(k, p_, sr.name, "control baseline")
        must_fail(f"local sweep {sr.name} Q={Q}, lanes rolled by one",
                  lambda: compare(k, p_.roll(1, 0), sr.name, "rolled"))
        if sr is PLUS_MUL:
            t_ = int(torch.nonzero(cols[0] >= 0)[0])
            cut = tl.clone()
            cut[0, t_] = 0.0
            p_cut = spmv_blocked_ref(cut, rows, cols, xq, sr)
            must_fail(f"local sweep {sr.name} Q={Q}, one tile dropped",
                      lambda: compare(k, p_cut, sr.name, "tile dropped"))
    print("wrong controls: " + json.dumps(controls))

    meta = {
        "spmv_blocked_cuda": (
            "src/repro_torch/kernels/csrc/semiring_spmm.cu",
            "src/repro/kernels/semiring_spmm/kernel.py:80"),
        "fused_step_cuda": (
            "src/repro_torch/kernels/csrc/semiring_superstep.cu",
            "src/repro/kernels/semiring_superstep/kernel.py:142"),
    }
    out = []
    for kernel, recs in calls.items():
        hot = recs[0]  # min-plus local sweep
        pm = [r for r in recs if r["library_ms"] is not None]
        out.append({
            "name": kernel, "route": "cuda", "source": meta[kernel][0],
            "replaces": meta[kernel][1], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "limit_used": max(r["limit_used"] for r in recs),
            "ms": hot["ms"], "eager_ms": hot["eager_ms"],
            "plain_ms": hot["plain_ms"],
            "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
            "library_ms": hot["library_ms"], "hot_call": hot["call"],
            "bound_share": hot["bound_share"],
            # the plus-mul calls, which have a library yardstick
            "plus_mul": {r["call"]: {k: r[k] for k in (
                "ms", "library_ms", "bound_ms", "bound_share")} for r in pm},
            # the Q = 32 calls of the query axis, launches on the query
            # path
            "q_lanes": {r["call"]: {k: r[k] for k in (
                "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bytes_ms", "issue_ms", "bound_share",
                "launches", "walk")} for r in recs
                if r.get("lanes") == QUERY_SWEEP[-1]},
            "controls": controls, "signed_zero_controls": special,
            "calls": recs, "card": card,
        })
    return out


# ---------------------------------------------------------------------------
# LM serving (starcoder2-7b): the attention kernels
# ---------------------------------------------------------------------------

# bf16 dense tensor-core peak of the one card on record (H100 SXM data
# sheet), FLOP/s
BF16_RATE = 989e12
# tol of attn_limit: the reference tests' rtol (tests/test_kernels.py:150
# and :197).  A bf16 output rounded one ulp apart differs by at most 2^-7
# of its value, well inside 2e-2; the absolute part scales with each row
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, Sq, Skv, H, K, d, causal, window, q_offset, dtype): FLASH_SWEEP of
# tests/test_kernels.py:127-136, then ragged Sq/Skv tails, G = 9 with
# starcoder2's d, windows longer than the sequence, one query row, a
# prefill continuing a cache (q_offset > 0)
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0, "float32"),
    (1, 128, 128, 8, 8, 64, True, 0, 0, "float32"),
    (2, 32, 32, 4, 1, 16, False, 0, 0, "float32"),
    (1, 64, 64, 2, 2, 32, True, 24, 0, "float32"),
    (1, 32, 96, 4, 2, 32, True, 0, 64, "float32"),
    (1, 64, 64, 4, 2, 32, True, 0, 0, "bfloat16"),
    (1, 128, 128, 2, 2, 128, True, 0, 0, "float32"),
    (1, 50, 50, 9, 1, 32, True, 16, 0, "float32"),
    (2, 37, 81, 4, 2, 64, True, 200, 44, "float32"),
    (1, 129, 129, 4, 2, 128, True, 50, 0, "float32"),
    (1, 300, 300, 36, 4, 128, True, 128, 0, "bfloat16"),
    (2, 100, 612, 36, 4, 128, True, 256, 512, "bfloat16"),
    (1, 77, 130, 8, 2, 64, False, 0, 0, "bfloat16"),
    (3, 1, 33, 4, 1, 16, True, 8, 32, "bfloat16"),
    (1, 200, 200, 16, 1, 128, True, 5000, 0, "bfloat16"),
]
# (B, S, H, K, d, window, dtype): DECODE_SWEEP of tests/test_kernels.py:
# 178-183, then G = 9, G = 16, windows longer than the cache, and caches
# long enough for many splits; every case has a sequence of length 1
DECODE_CASES = [
    (2, 128, 4, 2, 32, 0, "float32"),
    (1, 256, 8, 1, 64, 0, "float32"),
    (3, 128, 4, 4, 32, 48, "float32"),
    (2, 128, 8, 2, 64, 0, "bfloat16"),
    (3, 100, 9, 1, 128, 0, "float32"),
    (2, 77, 18, 2, 64, 500, "bfloat16"),
    (4, 300, 36, 4, 128, 64, "bfloat16"),
    (2, 1000, 16, 1, 128, 0, "bfloat16"),
    (1, 4096, 36, 4, 128, 0, "bfloat16"),
    (4, 5000, 36, 4, 128, 4096, "bfloat16"),
    (2, 3000, 36, 4, 128, 0, "float32"),
]
# the serving run: starcoder2-7b at full width and depth
SERVE_ARCH, SERVE_REQUESTS, SERVE_BATCH = "starcoder2-7b", 4, 4
SERVE_PROMPT, SERVE_NEW = 8192, 32
PARITY_S = 8192  # teacher-forcing prompt, batch 1
# the flash route of the serving prefill and the decode route of the
# serving decode steps (bf16, d = 128)
SERVE_FLASH_ROUTE = "bf16_wgmma"
SERVE_DECODE_ROUTE = "bf16_ring"
PARITY_TOL, PARITY_MARGIN = 5e-2, 2e-2  # tests/test_arch_smoke.py:103-109


def attn_limit(ref, tol):
    """Elementwise limit on |kernel - plain| for attention outputs (last
    dim the head dim): ``tol * (|ref| + min(1, 2 * row mean |ref|))``, a
    row being one query's output of one head.  The rounding of ``p`` and
    of the output scales with the row's magnitude: of order 1 where a row
    sees a few keys (the sweep's short sequences, where this is at most
    the reference tests' rtol = atol = ``tol``), near 0.03 where it sees
    thousands (the main path's).  A fixed atol of 2e-2 would pass a kernel
    that drops a key block there; the controls of :func:`attn_controls`
    show that such defects fail this limit."""
    a = ref.abs()
    return tol * (a + (2.0 * a.mean(dim=-1, keepdim=True)).clamp(max=1.0))


def attn_compare(kern, plain, tol: float, what: str):
    """Hold an attention kernel's output against its plain version within
    :func:`attn_limit`.  Returns (max abs error, largest share of the limit
    that any entry used, mean |plain|, max |plain|)."""
    import torch

    k, p = kern.float(), plain.float()
    need(k.shape == p.shape, f"{what}: shape {tuple(k.shape)} vs "
                             f"{tuple(p.shape)}")
    need(bool(torch.isfinite(k).all()), f"{what}: non-finite output")
    err = (k - p).abs()
    used = float((err / attn_limit(p, tol)).max())
    need(used <= 1.0, f"{what}: max abs error {float(err.max())} is "
                      f"{used:.3g}x the limit of attn_limit (tol {tol})")
    return float(err.max()), used, float(p.abs().mean()), float(p.abs().max())


def attn_controls(plain_out, controls, tol: float, what: str):
    """Deliberately wrong outputs (the plain version with the window edge
    one key off, the window's first 32-key block dropped, the causal edge
    one key off or the newest key lost) must each exceed :func:`attn_limit`: proof that the check sees
    such defects at this shape.  Returns {control: share of the limit}."""
    import torch

    lim = attn_limit(plain_out.float(), tol)
    out = {}
    for name, fn in controls.items():
        used = float(((fn().float() - plain_out.float()).abs() / lim).max())
        need(used > 1.0, f"{what}: the control '{name}' stays within the "
                         f"limit ({used:.3g}x); the check is too weak here")
        out[name] = used
    torch.cuda.empty_cache()
    return out


SWEEP_KEYS = ("max_abs_err", "limit_used", "mean_abs_plain", "max_abs_plain")


def attention_sweep(device="cuda", seed=1, log=print):
    """Both attention kernels against their plain versions on every case
    of FLASH_CASES and DECODE_CASES.  K/V are slices of a longer buffer,
    strided as the KV cache is.  Returns the number of comparisons."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dt))

    n = 0
    for case in FLASH_CASES:
        B, Sq, Skv, H, K, d, causal, window, qoff, dt = case
        q = randn(B, Sq, H, d, dt=dt)
        k = randn(B, Skv + 5, K, d, dt=dt)[:, :Skv]
        v = randn(B, Skv + 5, K, d, dt=dt)[:, :Skv]
        kw = dict(causal=causal, window=window, q_offset=qoff)
        got = attn_compare(flash_attention_cuda(q, k, v, **kw),
                           mha_ref(q, k, v, **kw), ATTN_TOL[dt],
                           f"flash {case}")
        log(f"  flash {case}: " + json.dumps(dict(zip(SWEEP_KEYS, got))))
        n += 1
    for case in DECODE_CASES:
        B, S, H, K, d, window, dt = case
        q = randn(B, H, d, dt=dt)
        k = randn(B, S + 3, K, d, dt=dt)[:, :S]
        v = randn(B, S + 3, K, d, dt=dt)[:, :S]
        lens = rng.integers(1, S + 1, B).astype(np.int32)
        lens[0] = 1
        lens[-1] = S if B > 1 else lens[-1]
        lt = torch.as_tensor(lens, device=device)
        got = attn_compare(decode_attention_cuda(q, k, v, lt, window=window),
                           decode_ref(q, k, v, lt, window=window),
                           ATTN_TOL[dt], f"decode {case} lengths "
                                         f"{lens.tolist()}")
        log(f"  decode {case}: " + json.dumps(dict(zip(SWEEP_KEYS, got))))
        n += 1
    torch.cuda.synchronize()
    return n


def attn_counters():
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    return flash_attention_cuda, decode_attention_cuda


def reset_attn_launches():
    """Both attention kernels' launch counts, in total and by route, to 0."""
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import kernel as flash

    flash.reset_launches()
    decode.reset_launches()


@contextlib.contextmanager
def capture_layer0():
    """While the serving path runs, record what the attention kernels are
    given at their first call of each kind: layer 0 of the prefill and of
    the first decode step (lengths copied, since the cache's grow in
    place)."""
    from repro_torch.models import attention

    got = {}
    flash, decode = attention.flash_attention_cuda, attention.decode_attention_cuda

    def flash_rec(q, k, v, **kw):
        got.setdefault("flash", (q, k, v, kw["window"], kw["q_offset"]))
        return flash(q, k, v, **kw)

    def decode_rec(q, k, v, lengths, **kw):
        got.setdefault("decode", (q, k, v, lengths.clone(), kw["window"]))
        return decode(q, k, v, lengths, **kw)

    attention.flash_attention_cuda = flash_rec
    attention.decode_attention_cuda = decode_rec
    try:
        yield got
    finally:
        attention.flash_attention_cuda = flash
        attention.decode_attention_cuda = decode


def serve_path(device="cuda", log=print):
    """The LM main path: starcoder2-7b at full width and depth, random
    weights from a seeded generator on the card, ``BatchedServer``
    answering SERVE_REQUESTS prompts of SERVE_PROMPT tokens with SERVE_NEW
    new tokens each, at batch SERVE_BATCH.  A second run must give the
    same tokens.  Returns what the later phases need."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_model_params

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase serve_init: {json.dumps({'seconds': time.perf_counter() - t0, 'arch': cfg.name, 'layers': cfg.num_layers, 'd_model': cfg.d_model, 'params': n_params, 'weights_GB': torch.cuda.memory_allocated() / 1e9})}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]

    def run():
        srv = BatchedServer(model, batch_size=SERVE_BATCH,
                            max_len=SERVE_PROMPT + SERVE_NEW + 8)
        done = srv.serve([Request(rid=i, tokens=p, max_new=SERVE_NEW)
                          for i, p in enumerate(prompts)])
        return srv, [r.out for r in done]

    flash, decode = attn_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    with capture_layer0() as shapes:
        srv, outs = run()
    launches = {"flash_attention_cuda": flash.launches,
                "decode_attention_cuda": decode.launches}
    routes = {"flash_attention_cuda": dict(flash.launches_by_route),
              "decode_attention_cuda": dict(decode.launches_by_route)}
    flash_routes = routes["flash_attention_cuda"]
    decode_routes = routes["decode_attention_cuda"]
    st = srv.stats
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "tokens": st["tokens"],
           "tokens_per_s": st["tokens"] / (st["prefill_s"] + st["decode_s"]),
           "decode_tokens_per_s": SERVE_REQUESTS * (SERVE_NEW - 1)
           / st["decode_s"],
           "prompt_tokens_per_s": SERVE_REQUESTS * SERVE_PROMPT
           / st["prefill_s"], "peak_GB": peak, "launches": launches,
           "flash_launches_by_route": flash_routes,
           "decode_launches_by_route": decode_routes}
    log(f"phase serve: {json.dumps(rec)}")
    need(len(outs) == SERVE_REQUESTS, "serve: requests lost")
    need(all(len(o) == SERVE_NEW for o in outs), "serve: token counts")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o),
         "serve: a padded vocab entry won")
    need(st["finite"], "serve: non-finite logits")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the serving path")
    need(flash_routes[SERVE_FLASH_ROUTE] == launches["flash_attention_cuda"]
         == cfg.num_layers, f"serve: the prefill's flash launches took the "
                            f"routes {flash_routes}, not all "
                            f"{cfg.num_layers} {SERVE_FLASH_ROUTE}")
    n_decode = cfg.num_layers * (SERVE_NEW - 1) * -(-SERVE_REQUESTS
                                                   // SERVE_BATCH)
    need(decode_routes[SERVE_DECODE_ROUTE] == launches["decode_attention_cuda"]
         == n_decode, f"serve: the decode launches took the routes "
                      f"{decode_routes}, not all {n_decode} "
                      f"{SERVE_DECODE_ROUTE}")
    srv2, outs2 = run()
    need(outs2 == outs, "serve: a second run gave other tokens")
    log(f"phase serve_repeat: {json.dumps({'prefill_s': srv2.stats['prefill_s'], 'decode_s': srv2.stats['decode_s'], 'identical_tokens': True})}")
    log(f"  first tokens: {[o[:8] for o in outs]}")
    return {"cfg": cfg, "model": model, "prompts": prompts, "outs": outs,
            "launches": launches, "routes": routes, "serve": rec,
            "shapes": shapes}


def serve_profile(lm, device="cuda", log=print, n_decode=4, top=12):
    """Where the serving time goes: ``torch.profiler`` over one prefill of
    the SERVE_BATCH prompts and over ``n_decode`` decode steps.  Prints,
    for each window, the host wall time, the device time the profiler saw
    (the sum of the kernels' own times), the device's idle share of the
    wall time, the kernels that took the most device time, and every
    attention kernel of the port (a decode call's split kernel and its
    combine launch, which the top rows may leave out)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, init_serve_cache, prefill

    cfg, model = lm["cfg"], lm["model"]
    B, S = SERVE_BATCH, SERVE_PROMPT
    toks = np.stack(lm["prompts"][:B])
    nxt = np.array([[o[0]] for o in lm["outs"][:B]], np.int32)
    cache = init_serve_cache(cfg, B, S + n_decode + 8, device=device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}

    def window(name, fn):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side entries only (kernels, copies): the host ops that
        # launched them carry the same time again
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(r[0] for r in rows)
        rec = {"wall_ms": wall * 1e3, "device_ms": busy,
               "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
               "device_launches": sum(r[1] for r in rows),
               "top": [{"ms": ms, "calls": n, "name": k[:90]}
                       for ms, n, k in rows[:top]],
               "attention": [{"ms": ms, "calls": n, "name": k[:90]}
                             for ms, n, k in rows if "attn_kernels::" in k]}
        out[name] = rec
        log(f"phase serve_profile {name}: {json.dumps(rec)}")
        if not busy:
            log("  the profiler saw no device time")

    def run_prefill():
        nonlocal cache
        _, cache = prefill(model, {"tokens": toks, "cache": cache})

    def run_decode():
        nonlocal cache
        for i in range(n_decode):
            _, cache = decode_step(model, {
                "tokens": nxt, "pos": np.full(B, S + i, np.int32),
                "cache": cache})

    window("prefill", run_prefill)
    window(f"decode x{n_decode}", run_decode)
    del cache
    torch.cuda.empty_cache()
    return out


def teacher_forcing(lm, device="cuda", log=print):
    """Prefilling S + 1 tokens and prefilling S then decoding one must give
    the same last-token logits (tests/test_arch_smoke.py:67-109): the
    flash kernel against the decode kernel over all layers."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_serve_cache, prefill

    cfg, model = lm["cfg"], lm["model"]
    S, V = PARITY_S, cfg.vocab_size
    toks = np.random.default_rng(1).integers(0, V, (1, S + 1)).astype(
        np.int32)
    t0 = time.perf_counter()
    cache = init_serve_cache(cfg, 1, S + 9, device=device)
    la, _ = prefill(model, {"tokens": toks, "cache": cache})
    cache = init_serve_cache(cfg, 1, S + 9, device=device)
    _, cache = prefill(model, {"tokens": toks[:, :S], "cache": cache})
    lb, _ = decode_step(model, {"tokens": toks[:, S:],
                                "pos": np.array([S], np.int32),
                                "cache": cache})
    del cache
    va = la[:, -1, :V].float().cpu().numpy()
    vb = lb[:, -1, :V].float().cpu().numpy()
    need(np.isfinite(va).all() and np.isfinite(vb).all(),
         "teacher forcing: non-finite logits")
    err = float(np.abs(va - vb).max())
    need(np.allclose(va, vb, rtol=PARITY_TOL, atol=PARITY_TOL),
         f"teacher forcing: logits differ by {err} beyond {PARITY_TOL}")
    top2 = np.sort(va[0])[-2:]
    margin = float(top2[1] - top2[0])
    if margin > PARITY_MARGIN:
        need(va[0].argmax() == vb[0].argmax(), "teacher forcing: top-1 "
                                               "differs")
    log(f"phase teacher_forcing: {json.dumps({'seconds': time.perf_counter() - t0, 'S': S, 'max_abs_err': err, 'logit_std': float(va.std()), 'top2_margin': margin, 'top1_equal': bool(va[0].argmax() == vb[0].argmax())})}")
    torch.cuda.empty_cache()
    return err


def split_sweep(decode_k, args, log=print, counts=(1, 2, 4, 8, 16)):
    """Device ms of the decode kernel at one shape for several split
    counts with K/V out of L2 (:func:`cold_ms`; back to back under
    ``warm``), and for the schedule's own (``num_splits``, the wrapper's
    choice) under the key ``schedule``."""
    import torch

    from repro_torch.kernels.decode_attention import kernel

    q, k, v, lengths, window = args
    S, K = k.shape[1], k.shape[2]
    chosen = kernel.num_splits
    out, warm = {}, {}

    def call():
        return decode_k(q, k, v, lengths, window=window)

    try:
        for n in counts:
            kernel.num_splits = lambda *a, n=n: n
            out[n], warm[n] = cold_ms(call), cuda_ms(call)
    finally:
        kernel.num_splits = chosen
    out["warm"] = warm
    out["schedule"] = {
        "splits": chosen(q.shape[0] * K, min(S, window) if window else S,
                         torch.cuda.get_device_properties(
                             q.device).multi_processor_count),
        "ms": cold_ms(call), "warm_ms": cuda_ms(call)}
    log(f"  decode split sweep (ms by split count): {json.dumps(out)}")
    return out


def visible_pairs(Sq, Skv, q_offset, window):
    """(query, key) pairs the causal window mask lets through, per head
    and sequence."""
    import numpy as np

    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_report(shapes, launches, routes, card, rate, device="cuda",
                     log=print):
    """Each attention kernel timed at the serving run's shapes (layer 0,
    as ``capture_layer0`` recorded them)
    and at the repo's named 32k shapes: device ms (CUDA-graph replay),
    eager ms, plain ms, one PyTorch library call (SDPA, memory-efficient
    backend) as a yardstick, and the bound.  The decode kernel's device,
    plain and library ms are taken with K/V out of L2 (:func:`cold_ms`),
    as on the main path, and back to back under ``*warm_ms``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import DECODE_32K, PREFILL_32K, get_config
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import mha_ref

    flash_k, decode_k = attn_counters()
    calls = {"flash_attention_cuda": [], "decode_attention_cuda": []}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def library(fn, plain_out, what, strict=True, timer=cuda_ms):
        """Time the yardstick, or say why it could not run (it is never on
        the port's path).  A yardstick that disagrees with the plain
        version fails the smoke, or with ``strict=False`` (the second
        yardstick) is reported and not timed."""
        try:
            out = fn()
        except RuntimeError as e:  # a backend that refuses these inputs
            log(f"  {what}: library call unavailable: {str(e)[:300]}")
            return None, str(e)[:200]
        try:
            attn_compare(out, plain_out, ATTN_TOL["bfloat16"],
                         what + " library call")
        except SmokeFailure as e:
            if strict:
                raise
            log(f"  {what}: library call disagrees, not timed: {e}")
            return None, f"disagrees with plain: {e}"[:200]
        del out
        return timer(fn), None

    def finish(kernel, name, kfn, pfn, lfn, moved, ops, controls,
               cudnn_fn=None, cold=False):
        kout, pout = kfn(), pfn()
        err, used, mean_p, max_p = attn_compare(kout, pout,
                                                ATTN_TOL["bfloat16"], name)
        ctl = attn_controls(pout, controls, ATTN_TOL["bfloat16"], name)
        timer = cold_ms if cold else cuda_ms
        lib_ms, lib_note = library(lfn, pout, name, timer=timer)
        if cudnn_fn is not None:
            cudnn_ms, cudnn_note = library(cudnn_fn, pout, name + " (cuDNN)",
                                           strict=False)
        t_bytes, t_ops = moved / rate, ops / BF16_RATE
        rec = {"call": name, "ms": timer(kfn),
               "eager_ms": cuda_ms(kfn, graph=False),
               "plain_ms": timer(pfn), "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "flop": ops, "max_abs_err": err,
               "limit_used": used, "mean_abs_plain": mean_p,
               "max_abs_plain": max_p, "controls_limit_used": ctl}
        if lib_note:
            rec["library_note"] = lib_note
        if cold:
            rec.update(timing="K/V out of L2", warm_ms=cuda_ms(kfn),
                       plain_warm_ms=cuda_ms(pfn),
                       library_warm_ms=None if lib_ms is None
                       else cuda_ms(lfn))
        if cudnn_fn is not None:
            rec["cudnn_ms"] = cudnn_ms
            if cudnn_note:
                rec["cudnn_note"] = cudnn_note
        calls[kernel].append(rec)
        log(f"  {kernel} {name}: " + json.dumps(rec))
        del kout, pout
        torch.cuda.empty_cache()

    def flash_call(name, q, k, v, window, q_offset):
        B, Sq, H, d = q.shape
        Skv, K = k.shape[1], k.shape[2]
        G = H // K
        kw = dict(causal=True, window=window, q_offset=q_offset)
        kx = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vx = v.repeat_interleave(G, dim=2).transpose(1, 2)
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window

        def sdpa(backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), kx, vx, attn_mask=mask).transpose(1, 2)

        def lfn():
            return sdpa(SDPBackend.EFFICIENT_ATTENTION)

        def cudnn_fn():
            return sdpa(SDPBackend.CUDNN_ATTENTION)

        pairs = B * visible_pairs(Sq, Skv, q_offset, window)
        need(window > 32, f"{name}: the controls need a window, got {window}")
        controls = {
            "window edge one key off": lambda: mha_ref(
                q, k, v, causal=True, window=window - 1, q_offset=q_offset),
            "window's first 32 keys dropped": lambda: mha_ref(
                q, k, v, causal=True, window=window - 32, q_offset=q_offset),
            "causal edge one key off": lambda: mha_ref(
                q, k, v, causal=True, window=window, q_offset=q_offset - 1),
        }
        finish("flash_attention_cuda", name,
               lambda: flash_k(q, k, v, **kw), lambda: mha_ref(q, k, v, **kw),
               lfn, nbytes(q, q) + 2 * B * Skv * K * d * k.element_size(),
               4 * d * H * pairs, controls, cudnn_fn)

    def decode_call(name, q, k, v, lengths, window):
        B, H, d = q.shape
        S, K = k.shape[1], k.shape[2]
        G = H // K
        kx = k.transpose(1, 2).contiguous()
        vx = v.transpose(1, 2).contiguous()
        pos = torch.arange(S, device=q.device)[None]
        lens = lengths[:, None].long()
        mask = pos < lens
        if window:
            mask &= pos > lens - 1 - window
        mask = mask[:, None, None, :].expand(B, K, G, S)

        def lfn():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(
                    q.reshape(B, K, G, d), kx, vx,
                    attn_mask=mask).reshape(B, H, d)

        span = lengths.long().clamp(0, S)
        keys = int((span.clamp(max=window) if window else span).sum())
        need(window > 32, f"{name}: the controls need a window, got {window}")
        shorter = (lengths - 1).clamp(min=1)
        controls = {
            "window edge one key off": lambda: decode_ref(
                q, k, v, lengths, window=window - 1),
            "window's first 32 keys dropped": lambda: decode_ref(
                q, k, v, lengths, window=window - 32),
            "newest key lost": lambda: decode_ref(
                q, k, v, shorter, window=window - 1),
        }
        finish("decode_attention_cuda", name,
               lambda: decode_k(q, k, v, lengths, window=window),
               lambda: decode_ref(q, k, v, lengths, window=window), lfn,
               2 * keys * K * d * k.element_size() + nbytes(q, q, lengths),
               4 * d * H * keys, controls, cold=True)

    t0 = time.perf_counter()
    flash_call("serve prefill, layer 0", *shapes["flash"])
    decode_call("serve decode step 1, layer 0", *shapes["decode"])
    calls["decode_attention_cuda"][-1]["split_sweep_ms"] = split_sweep(
        decode_k, shapes["decode"], log)
    shapes.clear()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=device).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # prefill_32k's sequence (configs/base.py:34), one prompt
    S = PREFILL_32K.seq_len

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    flash_call(f"prefill_32k sequence (B=1, S={S})", randn(1, S, H, d),
               randn(1, S, K, d), randn(1, S, K, d), cfg.sliding_window, 0)
    torch.cuda.empty_cache()
    # decode_32k's cache (configs/base.py:35), one layer
    Bd, S = DECODE_32K.global_batch, DECODE_32K.seq_len
    lengths = torch.randint(1, S + 1, (Bd,), generator=gen, device=device,
                            dtype=torch.int32)
    decode_call(f"decode_32k cache (B={Bd}, S={S})", randn(Bd, H, d),
                randn(Bd, S, K, d), randn(Bd, S, K, d), lengths,
                cfg.sliding_window)
    torch.cuda.empty_cache()
    log(f"phase attention_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")

    meta = {
        "flash_attention_cuda": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:86"),
        "decode_attention_cuda": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:83"),
    }
    out = []
    for kernel, recs in calls.items():
        hot = recs[0]  # the serving run's shape
        out.append({
            "name": kernel, "route": "cuda", "source": meta[kernel][0],
            "replaces": meta[kernel][1], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "limit_used": max(r["limit_used"] for r in recs),
            "ms": hot["ms"], "eager_ms": hot["eager_ms"],
            "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
            "bound_by": hot["bound_by"], "library_ms": hot["library_ms"],
            "hot_call": hot["call"], "calls": recs, "card": card,
        })
        out[-1]["launches_by_route"] = routes[kernel]
        out[-1].update({key: hot[key] for key in ("timing", "warm_ms")
                        if key in hot})
        out[-1]["serve_route"] = (SERVE_FLASH_ROUTE
                                  if kernel == "flash_attention_cuda"
                                  else SERVE_DECODE_ROUTE)
    return out



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"HBM rate for bounds {rate / 1e12} TB/s")
    torch.backends.cuda.matmul.allow_tf32 = False  # library yardstick: fp32

    # 2. build
    from repro_torch.kernels import _build

    _build.library(verbose=True)
    print(f"phase build: {json.dumps({'seconds': _build.build_seconds})}")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "warning")):
            print("  ptxas:", line.strip())

    # 3. kernels against plain versions
    t0 = time.perf_counter()
    n = kernel_sweep("cuda")
    print(f"phase kernel_sweep: {json.dumps({'seconds': time.perf_counter() - t0, 'comparisons': n})}")

    # 4. the attention kernels against their plain versions
    t0 = time.perf_counter()
    n = attention_sweep("cuda")
    print(f"phase attention_sweep: {json.dumps({'seconds': time.perf_counter() - t0, 'comparisons': n})}")

    # 5. the graph main path, launches counted
    from repro_torch.configs.goffish_tr import TR_SMALL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda

    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    reset_attn_launches()
    w0 = walk_counts()
    with call_shapes() as shape_launches:
        keep = main_path(TR_SMALL, "cuda")
    launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                "fused_step_cuda": fused_step_cuda.launches}
    walks = {"main": check_walks("main path", shape_launches, w0,
                                 walk_counts())}
    print(f"main path launches: {json.dumps(launches)}")
    print("main path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(shape_launches.items())}))
    print(f"main path launches by walk: {json.dumps(walks['main'])}")
    for k, v in launches.items():
        need(sum(n for (kk, _), n in shape_launches.items() if kk == k)
             == v, f"{k}: launches by call shape do not sum to {v}")
    print(f"main path cuts: {json.dumps(keep['cut'])} (dense phases run "
          f"all {TR_SMALL.num_instances} instances)")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the main path")
    print(f"peak device memory GB: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    # 5b. the query axis over phase 5's staged batch, launches counted
    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    w0 = walk_counts()
    with call_shapes() as query_shapes:
        query = query_phase(keep, "cuda")
    query_launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                      "fused_step_cuda": fused_step_cuda.launches}
    walks["query"] = check_walks("query path", query_shapes, w0,
                                 walk_counts())
    print(f"query path launches by walk: {json.dumps(walks['query'])}")
    for k, v in walks["query"].items():
        need(v["lane_walk"] > 0, f"{k}: no launch on the lane walk on the "
                                 f"query path")
    print(f"phase query: {json.dumps({'seconds': time.perf_counter() - t0})}")
    print(f"query path launches: {json.dumps(query_launches)}")
    print("query path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(query_shapes.items())}))
    for k, v in query_launches.items():
        need(sum(n for (kk, _), n in query_shapes.items() if kk == k)
             == v, f"{k}: query launches by call shape do not sum to {v}")
        need(any(n > 0 for (kk, c), n in query_shapes.items()
                 if kk == k and c.endswith(f" Q={QUERY_LANES}")),
             f"{k} was not launched in its Q-lane form on the query path")

    # 6. the graph path from a GoFS deployment, launches counted
    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    w0 = walk_counts()
    with call_shapes() as gofs_shapes:
        gofs = gofs_path(TR_SMALL, keep, "cuda")
    gofs_launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                     "fused_step_cuda": fused_step_cuda.launches}
    walks["gofs"] = check_walks("gofs path", gofs_shapes, w0, walk_counts())
    print(f"gofs path launches by walk: {json.dumps(walks['gofs'])}")
    print(f"phase gofs_path: {json.dumps({'seconds': time.perf_counter() - t0})}")
    print(f"gofs path launches: {json.dumps(gofs_launches)}")
    print("gofs path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(gofs_shapes.items())}))
    print(f"gofs path cuts: {json.dumps(gofs['cut'])} (TR_SMALL: "
          f"{TR_SMALL.num_instances} instances)")
    for k, v in gofs_launches.items():
        need(sum(n for (kk, _), n in gofs_shapes.items() if kk == k) == v,
             f"{k}: GoFS-path launches by call shape do not sum to {v}")
        need(v > 0, f"{k} was not launched on the GoFS path")
    keep.pop("in_memory")
    torch.cuda.empty_cache()

    # 7. the graph kernels at the main path's shapes
    t0 = time.perf_counter()
    report = kernel_report(keep, launches, shape_launches, query_shapes, card,
                           rate)
    for rec in report:
        k = rec["name"]
        rec["query_launches"] = query_launches[k]
        rec["query_launches_by_call_shape"] = {
            c: n for (kk, c), n in sorted(query_shapes.items()) if kk == k}
        rec["query"] = {m: {key: query[m][key] for key in (
            "seconds", "launches", "host_syncs", "slowest_lane_launches",
            "sum_over_lanes_launches")} for m in ("spmv", "fused")}
        rec["query"]["single_source_runs"] = query["single_source_runs"]
        rec["launches_by_walk"] = {path: w[k] for path, w in walks.items()}
        rec["gofs_launches"] = gofs_launches[k]
        rec["gofs_launches_by_call_shape"] = {
            c: n for (kk, c), n in sorted(gofs_shapes.items()) if kk == k}
        # the session's launches are a part of the GoFS path's
        rec["session_launches"] = gofs["session"]["launches"][k]
        rec["session_launches_by_call_shape"] = {
            c[len(k) + 1:]: n for c, n in
            gofs["session"]["launches_by_call_shape"].items()
            if c.startswith(k + " ")}
    print(f"phase kernel_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")
    del keep
    torch.cuda.empty_cache()

    # 8. the LM serving path, launches counted (inside serve_path)
    lm = serve_path("cuda")
    launches.update(lm["launches"])
    serve_profile(lm, "cuda")
    # 9. teacher forcing: the flash kernel against the decode kernel
    teacher_forcing(lm, "cuda")
    # 10. the attention kernels at the serving run's and the 32k shapes
    shapes = lm.pop("shapes")
    routes = lm.pop("routes")
    lm.clear()
    torch.cuda.empty_cache()
    report += attention_report(shapes, launches, routes, card, rate)
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
