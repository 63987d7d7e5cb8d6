#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain PyTorch version on the card, both
   semirings, B in {32, 64, 128}, padding, an empty structure, ``nnz`` and
   the fused call shapes (with and without the combine and the vote):
   min-plus bitwise (same inf pattern), plus-mul within the limit of
   :func:`plus_mul_limit`, halt votes exactly equal;
4. the main path at TR_SMALL (16,384 vertices, 48 instances, 8
   partitions, B=64), dense layout, through ``TemporalEngine.run``:
   sequential SSSP in ``spmv`` and ``fused`` mode (bitwise equal, and
   equal to the numpy oracle), independent PageRank (10 iterations) in both
   modes (within :func:`plus_mul_limit` of each other, and within 1e-4
   relative of the float64 oracle), one eventually/``merge="mean"`` run
   and one sparse-layout run on a few instances.  Kernel launch counts are
   zeroed before and read after;
5. each kernel at the main path's shapes: device time (20 calls replayed
   from one CUDA graph) and eager-call time, the plain version's device
   time, the bound (bytes over the card's HBM bandwidth) and, for
   plus-mul, one PyTorch call computing the same function (a dense
   batched product), printed as one JSON line;
6. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.
"""
from __future__ import annotations

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
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(cfg, device="cuda", n_sparse=4, log=print):
    """Drive the port's TemporalEngine at ``cfg``.  Returns a dict of what
    phase 5 needs (one instance's staged tiles and states) and the
    per-run records."""
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
    del tiles, btiles
    if device == "cuda":
        torch.cuda.empty_cache()
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

    # states for phase 5: the converged SSSP state and its boundary
    x_sssp = torch.as_tensor(
        bg.scatter_vertex(r_sp.final.astype(np.float32), INF), device=device)
    x_pr = torch.as_tensor(bg.scatter_vertex(p_sp.values[0], 0.0),
                           device=device)
    keep.update(bg=bg, x_sssp=x_sssp, x_pr=x_pr, eng=eng["spmv"],
                runs=runs, cut={"sparse_instances": n_sp,
                                "eventually_instances": n_ev})
    return keep


# ---------------------------------------------------------------------------
# phase 5: kernels at the main path's shapes
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


def kernel_report(keep, launches, card, rate):
    """One JSON record per kernel: the top-level numbers are its hot
    main-path call (the min-plus local sweep of the SSSP fixpoint); every
    main-path call shape is listed under ``calls``."""
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.core.superstep import _publish
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref

    bg, eng = keep["bg"], keep["eng"]
    rows, cols, brows, bcols = eng._index
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

    def record(kernel, name, sr, kfn, pfn, lfn, moved, ops):
        kout, pout = kfn(), pfn()
        if isinstance(kout, tuple):
            kc, pc = kout[1], pout[1]
            need((kc is None and pc is None) or torch.equal(kc, pc),
                 f"{name}: votes differ")
            kout, pout = kout[0], pout[0]
        err, used = compare(kout, pout, sr.name, name)
        if lfn is not None:  # the yardstick computes the same function
            compare(lfn().reshape(pout.shape), pout, sr.name,
                    name + " library call")
        rec = {
            "call": name, "semiring": sr.name,
            "ms": cuda_ms(kfn), "eager_ms": cuda_ms(kfn, graph=False),
            "plain_ms": cuda_ms(pfn),
            "library_ms": None if lfn is None else cuda_ms(lfn),
            "bound_ms": max(moved / rate, ops / 67e12) * 1e3,
            "bound_by": "bytes" if moved / rate >= ops / 67e12
            else "operations",
            "bytes": moved, "max_abs_err": err, "limit_used": used,
            "max_abs_plain": float(pout.abs().max()),
        }
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
               lambda: spmv_blocked_cuda(tl, rows, cols, x, sr),
               lambda: spmv_blocked_ref(tl, rows, cols, x, sr),
               lib_local, moved, 2 * n_local * B * B)
        moved = (n_bound * tile_b + nbytes(brows, bcols, bnd) + P * Vp * 4)
        record("spmv_blocked_cuda", f"consume {sr.name}", sr,
               lambda: spmv_blocked_cuda(btl, brows, bcols, bnd[None], sr,
                                         n_out_blocks=nvb),
               lambda: spmv_blocked_ref(btl, brows, bcols, bnd[None], sr,
                                        n_out_blocks=nvb),
               lib_bound, moved, 2 * n_bound * B * B)

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
                   xref=xref, vm=vm: fused_step_cuda(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb),
                   lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                   xref=xref, vm=vm: fused_step_ref(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb),
                   lfn, moved, 2 * n_t * B * B)

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
        out.append({
            "name": kernel, "route": "cuda", "source": meta[kernel][0],
            "replaces": meta[kernel][1], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "limit_used": max(r["limit_used"] for r in recs),
            "ms": hot["ms"], "eager_ms": hot["eager_ms"],
            "plain_ms": hot["plain_ms"],
            "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
            "library_ms": hot["library_ms"], "hot_call": hot["call"],
            "calls": recs, "card": card,
        })
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
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels against plain versions
    t0 = time.perf_counter()
    n = kernel_sweep("cuda")
    print(f"phase kernel_sweep: {json.dumps({'seconds': time.perf_counter() - t0, 'comparisons': n})}")

    # 4. the main path, launches counted
    from repro_torch.configs.goffish_tr import TR_SMALL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda

    spmv_blocked_cuda.launches = 0
    fused_step_cuda.launches = 0
    keep = main_path(TR_SMALL, "cuda")
    launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                "fused_step_cuda": fused_step_cuda.launches}
    print(f"main path launches: {json.dumps(launches)}")
    print(f"main path cuts: {json.dumps(keep['cut'])} (dense phases run "
          f"all {TR_SMALL.num_instances} instances)")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the main path")
    print(f"peak device memory GB: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    # 5. kernels at the main path's shapes
    t0 = time.perf_counter()
    report = kernel_report(keep, launches, card, rate)
    print(f"phase kernel_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
