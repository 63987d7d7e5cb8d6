"""One rank of a ``torch.distributed`` mesh for ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py SPEC_JSON

SPEC: ``rank``, ``world``, ``data``, ``model``, ``init`` (a ``file://``
rendezvous), ``device`` and ``backend`` (``cpu`` and ``gloo`` unless
given), ``inputs`` (a pickle the test wrote: the port's blocked
graph, the weight matrices and the path of a GoFS deployment of the
same collection), ``out`` (this rank's result pickle) and
``cases`` (names from :data:`CASES`).  Every rank runs every case with
the same inputs (the mesh's contract) and writes what it got back;
``local`` entries hold what is this rank's own (fills, exchange
counters).  It imports only torch, numpy and the port.
"""
import json
import os
import pickle
import sys
import traceback
import warnings

import numpy as np
import torch

COMMS = ("dense", "ring", "ring-rs")
SOURCES = [0, 7, 42, 99]


def _res(r):
    return {"values": r.values, "final": r.final, "merged": r.merged,
            "supersteps": np.asarray(r.stats["supersteps"]),
            "local_sweeps": np.asarray(r.stats["local_sweeps"]),
            "occupancy": r.occupancy}


def _sssp(sources=None, **kw):
    from repro_torch.core.engine import (min_plus_program, source_init,
                                         sources_init)

    init = source_init(0) if sources is None else sources_init(sources)
    return min_plus_program("sssp", init=init, **kw)


def negative_zero_init(sources):
    """The SSSP seed with -0 at each source (one lane per source), +inf
    elsewhere: ``tests/test_torch_signed_zero.py``'s."""

    def init(bg):
        x0 = np.stack([bg.scatter_vertex(
            np.full(bg.part_of.shape, np.inf, np.float32), np.inf)
            for _ in sources])
        for q, s in enumerate(sources):
            x0[q, bg.part_of[s], bg.local_of[s]] = -0.0
        return x0

    return init


def case_patterns(ctx):
    """SSSP under every pattern and comm, Q = 1, dense and sync; and how
    often a ring's synced continuation (``bind_sync``) voted."""
    from repro_torch.core import comm as C
    from repro_torch.core.engine import TemporalEngine

    synced = []
    real = C.RingExchange.keep_running

    def counted(self, running):
        if self.sync_axes:
            synced.append(self.sync_axes)
        return real(self, running)

    C.RingExchange.keep_running = counted
    out = {}
    try:
        for comm in COMMS:
            eng = TemporalEngine(ctx["bg"], device="cpu", mesh=ctx["mesh"],
                                 comm=comm)
            for pat in ("sequential", "independent", "eventually"):
                merge = "mean" if pat == "eventually" else None
                n = len(synced)
                out[f"{comm}/{pat}"] = _res(eng.run(
                    _sssp(), ctx["lat"], pattern=pat, merge=merge))
                out[f"{comm}/{pat}"]["synced_votes"] = len(synced) - n
    finally:
        C.RingExchange.keep_running = real
    return out


def case_query(ctx):
    """SSSP with Q = 4 sources under every comm."""
    from repro_torch.core.engine import TemporalEngine

    out = {}
    for comm in COMMS:
        eng = TemporalEngine(ctx["bg"], device="cpu", mesh=ctx["mesh"],
                             comm=comm)
        for pat in ("sequential", "eventually"):
            merge = "mean" if pat == "eventually" else None
            out[f"{comm}/{pat}"] = _res(eng.run(
                _sssp(SOURCES), ctx["lat"], pattern=pat, merge=merge))
    return out


def case_layouts(ctx):
    """Sparse layout, async staging, fused kernel mode, warm start and the
    vertex-centric baseline (dense comm)."""
    from repro_torch.core.engine import TemporalEngine

    bg, mesh, lat = ctx["bg"], ctx["mesh"], ctx["lat"]
    out = {}
    sp = TemporalEngine(bg, device="cpu", mesh=mesh, layout="sparse")
    asy = TemporalEngine(bg, device="cpu", mesh=mesh, staging="async")
    both = TemporalEngine(bg, device="cpu", mesh=mesh, staging="async",
                          layout="sparse", comm="ring-rs")
    fused = TemporalEngine(bg, device="cpu", mesh=mesh, use_pallas="fused",
                           comm="ring")
    for pat in ("sequential", "independent"):
        out[f"sparse/{pat}"] = _res(sp.run(_sssp(), lat, pattern=pat))
        out[f"async/{pat}"] = _res(asy.run(_sssp(), lat, pattern=pat))
        out[f"fused/{pat}"] = _res(fused.run(_sssp(SOURCES), lat,
                                             pattern=pat))
    out["async_sparse/independent"] = _res(both.run(
        _sssp(SOURCES), lat, pattern="independent"))
    out["warm/independent"] = _res(asy.run(_sssp(), lat,
                                           pattern="independent",
                                           warm_start=True))
    out["vertex_centric/sequential"] = _res(TemporalEngine(
        bg, device="cpu", mesh=mesh, comm="ring").run(
        _sssp(subgraph_centric=False), lat, pattern="sequential"))
    # pre-staged host batches: dense tiles and a SparseBlocked, full width
    eng = TemporalEngine(bg, device="cpu", mesh=mesh)
    tiles = bg.fill_local_batch(lat)
    btiles = bg.fill_boundary_batch(lat)
    out["prestaged/independent"] = _res(eng.run(
        _sssp(), tiles=tiles, btiles=btiles, pattern="independent"))
    out["prestaged_sparse/independent"] = _res(sp.run(
        _sssp(), sparse=bg.stage_sparse(lat), pattern="independent"))
    return out


def case_pagerank(ctx):
    """PageRank (plus-mul) under every comm, layout and staging."""
    from repro_torch.core.engine import TemporalEngine, pagerank_program

    bg, mesh, w = ctx["bg"], ctx["mesh"], ctx["prw"]
    prog = pagerank_program(bg.part_of.shape[0], iters=10)
    out = {}
    for comm in COMMS:
        eng = TemporalEngine(bg, device="cpu", mesh=mesh, comm=comm)
        out[f"{comm}/eventually"] = _res(eng.run(prog, w, pattern="eventually",
                                                 merge="mean"))
    out["async/independent"] = _res(TemporalEngine(
        bg, device="cpu", mesh=mesh, staging="async").run(
        prog, w, pattern="independent"))
    out["sparse/sequential"] = _res(TemporalEngine(
        bg, device="cpu", mesh=mesh, layout="sparse").run(
        prog, w, pattern="sequential"))
    return out


def case_signed_zero(ctx):
    """±0 weights with -0 sources, and a NaN weight under caps: every
    comm, the published buffers holding both zeros and NaN."""
    from repro_torch.core.engine import TemporalEngine, min_plus_program

    out = {}
    for comm in COMMS:
        eng = TemporalEngine(ctx["bg"], device="cpu", mesh=ctx["mesh"],
                             comm=comm)
        for pat in ("sequential", "independent"):
            prog = min_plus_program("sssp", init=ctx["zero_init"])
            out[f"zero/{comm}/{pat}"] = _res(eng.run(prog, ctx["zw"],
                                                     pattern=pat))
        prog = min_plus_program("sssp", init=ctx["zero_init"],
                                max_supersteps=4, max_local_sweeps=6)
        out[f"nan/{comm}/sequential"] = _res(eng.run(prog, ctx["nw"],
                                                     pattern="sequential"))
    return out


def case_wrappers(ctx):
    """The five deprecated ``run_blocked`` wrappers with ``mesh=``."""
    from repro_torch.core.algorithms import (components, nhop, pagerank,
                                             sssp, tracking)

    bg, mesh = ctx["bg"], ctx["mesh"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        final, st = sssp.run_blocked(bg, ctx["lat"], 0, mesh=mesh,
                                     device="cpu")
        ranks, ss = pagerank.run_blocked(
            bg, ctx["src"], ctx["act"], num_vertices=bg.part_of.shape[0],
            iters=10, mesh=mesh, device="cpu")
        hist, reach = nhop.run_blocked(bg, ctx["lat"], 0, 4, mesh=mesh,
                                       device="cpu")
        labels = components.run_blocked_temporal(
            bg, ctx["src"], ctx["dst"], ctx["act"], mesh=mesh, device="cpu")
        trace = tracking.run_blocked(bg, ctx["plates"], ctx["plate"],
                                     ctx["start"], search_depth=4,
                                     mesh=mesh, device="cpu")
    return {"sssp": (final, np.asarray(st["supersteps"]),
                     np.asarray(st["local_sweeps"])),
            "pagerank": (ranks, np.asarray(ss)), "nhop": (hist, reach),
            "components": labels, "tracking": trace}


def case_session(ctx):
    """``GopherSession(mesh=...)``: plans and runs."""
    from repro_torch.gopher import GopherSession

    bg, mesh = ctx["bg"], ctx["mesh"]
    sess = GopherSession.from_blocked(
        bg, weights={"latency": ctx["lat"], "active": ctx["act"]},
        src=ctx["src"], dst=ctx["dst"], mesh=mesh, device="cpu")
    plans = {
        "sssp": sess.plan("sssp", source=0),
        "sssp_q": sess.plan("sssp", source=SOURCES[:3]),
        "pagerank": sess.plan("pagerank", iters=10),
        "sssp_ring": sess.plan("sssp", source=0, comm="ring",
                               layout="sparse"),
    }
    runs = sess.run_many([plans["sssp"], plans["pagerank"]])
    out = {"plans": plans, "explain": {k: p.explain()
                                       for k, p in plans.items()},
           "sssp": _res(runs[0].engine), "pagerank": _res(runs[1].engine),
           "sssp_q": sess.run(plans["sssp_q"]).output["final"],
           "sssp_ring": _res(sess.run(plans["sssp_ring"]).engine)}
    return out


def case_store(ctx):
    """``GopherSession(store, mesh=...)`` over a GoFS deployment: SSSP
    streamed (sequential and independent), PageRank streamed, SSSP
    staged whole (sync); each run's dense fills (instances, partitions)
    on the session's graph are this rank's own."""
    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession

    sess = GopherSession(GoFSStore(ctx["store"]), mesh=ctx["mesh"],
                         device="cpu")
    bg = sess.bg
    seen = []
    real = bg.fill_local_batch

    def counted(w, *a, **k):
        out = real(w, *a, **k)
        seen.append(tuple(out.shape[:2]))
        return out

    plans = {
        "stream_sequential": sess.plan("sssp", source=0, staging="async"),
        "stream_independent": sess.plan("sssp", source=0, staging="async",
                                        pattern="independent"),
        "stream_pagerank": sess.plan("pagerank", iters=10,
                                     staging="async"),
        "sync_sequential": sess.plan("sssp", source=0, staging="sync"),
    }
    out, local = {}, {}
    bg.fill_local_batch = counted
    try:
        for k, p in plans.items():
            seen.clear()
            out[k] = _res(sess.run(p).engine)
            local[k] = {"fills": list(seen),
                        "staging_passes":
                            sess.last_run_report["staging_passes"]}
    finally:
        del bg.fill_local_batch
    out["local"] = local
    return out


def case_temporal(ctx):
    """``pagerank_temporal`` and ``make_temporal_pagerank`` (12 iterations,
    the reference test's)."""
    from repro_torch.core.temporal import (make_temporal_pagerank,
                                           pagerank_temporal)

    bg, mesh = ctx["bg"], ctx["mesh"]
    V = bg.part_of.shape[0]
    out = {}
    for comm in COMMS:
        out[comm] = pagerank_temporal(bg, ctx["src"], ctx["act"], mesh,
                                      num_vertices=V, iters=12, comm=comm,
                                      device="cpu")
    fn = make_temporal_pagerank(mesh, block_size=bg.block_size,
                                num_boundary=bg.num_boundary,
                                num_vertices=V, iters=12)
    om = np.arange(bg.o_max)[None, :] < bg.n_out[:, None]
    t = torch.as_tensor
    ranks, merged = fn(
        t(bg.fill_local_batch(ctx["prw"], zero=0.0)),
        t(bg.fill_boundary_batch(ctx["prw"], zero=0.0)),
        t(bg.tiles_rc[:, :, 0]), t(bg.tiles_rc[:, :, 1]),
        t(bg.btiles_rc[:, :, 0]), t(bg.btiles_rc[:, :, 1]),
        t(bg.out_slot), t(bg.out_local), t(om), t(bg.global_of >= 0))
    out["runner"] = (ranks.numpy(), merged.numpy())
    return out


def case_spmd(ctx):
    """``make_spmd_superstep``: one superstep over every mesh dim, both
    semirings, from a state after one sweep (Q = 1 and Q = 2)."""
    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.core.superstep import make_spmd_superstep

    bg, mesh = ctx["bg"], ctx["mesh"]
    om = np.arange(bg.o_max)[None, :] < bg.n_out[:, None]
    t = torch.as_tensor
    struct = (t(bg.tiles_rc[:, :, 0]), t(bg.tiles_rc[:, :, 1]))
    out = {}
    for sr, w, zero in ((MIN_PLUS, ctx["lat"], float("inf")),
                        (PLUS_MUL, ctx["prw"], 0.0)):
        tiles = t(bg.fill_local_batch(w[:1], zero=zero)[0])
        btiles = t(bg.fill_boundary_batch(w[:1], zero=zero)[0])
        for comm in COMMS:
            run = make_spmd_superstep(mesh, sr, comm=comm)(bg.num_boundary)
            x = t(ctx["x0"][sr.name])
            out[f"{sr.name}/{comm}"] = run(
                x, *struct, tiles, t(bg.btiles_rc[:, :, 0]),
                t(bg.btiles_rc[:, :, 1]), btiles, t(bg.out_slot),
                t(bg.out_local), t(om), t(bg.global_of >= 0)).numpy()
    return out


def case_comm(ctx):
    """The backends alone: a ([Q,] P, NB) buffer with ±0, NaN and inf
    split over the model group, every comm; votes, sums, validations."""
    from repro_torch.core import comm as C
    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL

    mesh = ctx["mesh"]
    g = C.axis_group(mesh, ("model",))
    # a plus-mul ring folds in each rank's own order (the reference's
    # semantics): those sums are this rank's
    out = {"local": {}}
    for name in ("min", "sum"):
        buf = ctx["buf"][name]
        n = buf.shape[-2] // g.size
        mine = torch.as_tensor(buf[..., g.rank * n:(g.rank + 1) * n, :])
        sr = MIN_PLUS if name == "min" else PLUS_MUL
        for comm in COMMS:
            c = C.make_comm(comm, mesh=mesh)
            before = C.exchange_stats()["combine_bytes_sent"]
            got = c.combine_boundary(mine, sr).numpy()
            out[f"bytes/{name}/{comm}"] = \
                C.exchange_stats()["combine_bytes_sent"] - before
            (out["local"] if name == "sum" else out)[f"{name}/{comm}"] = got
    dense = C.make_comm("dense", mesh=mesh)
    flags = np.array([g.rank == 0, False, g.rank == g.size - 1])
    out["any_changed"] = dense.any_changed(flags)
    out["local_vote"] = dense.local_vote(flags)
    out["sum_scalar"] = float(dense.sum_scalar(torch.tensor(g.rank + 1.0)))
    ring = C.make_comm("ring", mesh=mesh).bind_sync(("data",))
    out["keep_running"] = ring.keep_running(
        C.axis_group(mesh, ("data",)).rank == 0)
    errs = {}
    for key, make in {
        "unbound": lambda: C.make_comm(C.DenseAllReduce(), mesh=mesh),
        "host": lambda: C.make_comm("host", mesh=mesh),
        "host_instance": lambda: C.make_comm(C.HostGather(), mesh=mesh),
        "no_mesh": lambda: C.make_comm(C.DenseAllReduce(axis_name=("model",))),
        "axes": lambda: C.make_comm(C.DenseAllReduce(axis_name=("nope",)),
                                    mesh=mesh),
        "sizes": lambda: C.make_comm(C.RingExchange(
            axis_name=("model",), axis_sizes=(g.size + 3,)), mesh=mesh),
        "not_a_mesh": lambda: C.make_comm("dense", mesh=object()),
    }.items():
        try:
            make()
            errs[key] = None
        except (ValueError, TypeError) as e:
            errs[key] = (type(e).__name__, str(e))
    ok = C.RingExchange(axis_name=("model",), axis_sizes=(g.size,))
    bound = C.make_comm(ok, mesh=mesh)
    out["prebuilt"] = (bound.axis_name, bound.axis_sizes,
                       bound.mesh is mesh, C.make_comm(bound, mesh=mesh)
                       is bound)
    out["errors"] = errs
    return out


def case_fills(ctx):
    """What one rank fills: an independent PageRank's fill calls (rows
    and partitions) and the engine's shard."""
    from repro_torch.core.engine import TemporalEngine, pagerank_program

    bg = ctx["bg"]
    seen = []
    real = bg.fill_local_batch

    def counted(w, *a, **k):
        out = real(w, *a, **k)
        seen.append(tuple(out.shape[:2]))
        return out

    bg.fill_local_batch = counted
    try:
        eng = TemporalEngine(bg, device="cpu", mesh=ctx["mesh"])
        r = eng.run(pagerank_program(bg.part_of.shape[0], iters=2),
                    ctx["prw"], pattern="independent")
    finally:
        del bg.fill_local_batch
    return {"local": {"fills": seen, "parts": eng.parts},
            "values": r.values}


def case_card(ctx):
    """On the card (``tests/test_torch_cuda.py``): sequential SSSP in both
    kernel modes and independent SSSP with Q = 4 under every comm,
    independent PageRank, and the wrong control — a combine that keeps
    only this rank's partial."""
    import dataclasses

    from repro_torch.core import comm as C
    from repro_torch.core.engine import TemporalEngine, pagerank_program

    @dataclasses.dataclass(frozen=True)
    class SkipPeer(C.DenseAllReduce):
        name: str = "skip-peer"

        def combine_boundary(self, buf, sr):
            return C._stack_fold(buf, sr)

    bg, mesh, lat, dev = ctx["bg"], ctx["mesh"], ctx["lat"], ctx["device"]
    out = {}
    for comm in COMMS:
        for mode in ("spmv", "fused"):
            out[f"{comm}/{mode}"] = _res(TemporalEngine(
                bg, device=dev, mesh=mesh, comm=comm, use_pallas=mode).run(
                _sssp(), lat, pattern="sequential"))
        out[f"{comm}/query"] = _res(TemporalEngine(
            bg, device=dev, mesh=mesh, comm=comm).run(
            _sssp(SOURCES), lat, pattern="independent"))
    out["pagerank"] = _res(TemporalEngine(bg, device=dev, mesh=mesh).run(
        pagerank_program(bg.part_of.shape[0], iters=10), ctx["prw"],
        pattern="independent"))
    out["control"] = _res(TemporalEngine(
        bg, device=dev, mesh=mesh, comm=SkipPeer(axis_name=("model",))).run(
        _sssp(), lat, pattern="sequential"))
    return out


CASES = {k[5:]: v for k, v in dict(globals()).items()
         if k.startswith("case_")}


def main(spec) -> int:
    from repro_torch.core.comm import exchange_stats, reset_exchange_stats
    from repro_torch.launch.mesh import init_mesh

    torch.set_num_threads(1)
    device = spec.get("device", "cpu")
    mesh = init_mesh(spec["data"], spec["model"],
                     backend=spec.get("backend", "gloo"), device=device,
                     init_method=spec["init"], rank=spec["rank"],
                     world_size=spec["world"],
                     timeout=spec.get("timeout", 120))
    with open(spec["inputs"], "rb") as f:
        ctx = pickle.load(f)
    ctx["mesh"], ctx["device"] = mesh, device
    ctx["zero_init"] = negative_zero_init(ctx["zero_sources"])
    results = {}
    for name in spec["cases"]:
        reset_exchange_stats()
        try:
            results[name] = CASES[name](ctx)
        except Exception:  # reported to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
        results[name] = dict(results[name])
        results[name].setdefault("local", {})
        results[name]["local"]["exchange"] = exchange_stats()
    with open(spec["out"], "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    # every rank's last messages are delivered before any rank closes
    # its connections
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    code = main(json.loads(sys.argv[1]))
    # the process group's C++ threads can abort the interpreter's own
    # teardown ("terminate called without an active exception", now and
    # then under load): the results are written, so leave without it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
