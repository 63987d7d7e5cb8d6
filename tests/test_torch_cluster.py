"""The port's cluster runtime against the JAX package's
(``tests/test_cluster.py``'s cases, on the port).

* ``shard_range``, ``partition_shard`` and ``shard_of_partition`` equal
  to the reference's for P up to 9 and N up to 4.
* A mixed exchange: a reference ``TcpExchange`` and a port one, in two
  threads, either as the root — the wire format is shared, the allgather
  is rank-ordered, and a tag divergence raises on both sides.
* ``ClusterGather`` on in-thread runtimes equal to the reference's
  ``_host_fold_*`` over the whole buffer, both semirings, with and
  without a query axis, and the lane-wise OR vote.
* ``fill_*_batch(parts=)``, dense and sparse (with
  ``alloc_batch_buffers(parts=)``), bitwise the reference's on TINY and
  TR_TINY.
* ``shard_stream`` chunks equal to the reference's shard fills, per-host
  bytes below a full stage, span divergence raising, ``bind`` reaching
  the prefetcher.
* N in-thread port engines, then port sessions, on the CPU: SSSP
  (sequential), PageRank, components, warm SSSP and SSSP with 3 sources,
  bitwise equal to the single-process port run and to the reference's
  single-process stacked run.
* ``python -m repro_torch.launch.cluster_graph --check`` in worker
  processes on the CPU, over the TCP lane alone and beside a gloo
  process group.

Every wait takes a timeout.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.cluster import runtime as j_rt
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.comm import _host_fold_min as j_fold_min
from repro.core.comm import _host_fold_sum as j_fold_sum
from repro.core.engine import TemporalEngine as JTemporalEngine
from repro.core.engine import min_plus_program as j_min_plus_program
from repro.core.engine import pagerank_program as j_pagerank_program
from repro.core.engine import source_init as j_source_init
from repro.core.engine import sources_init as j_sources_init
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition_graph
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
from repro.gopher import GopherSession as JGopherSession
import repro_torch.core.engine as T
from repro_torch.cluster import ClusterGather, shard_stream
from repro_torch.cluster import runtime as p_rt
from repro_torch.cluster.gather import cluster_comm
from repro_torch.configs.base import GraphConfig
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core.algorithms.pagerank import edge_weights_for_instances
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
from repro_torch.gofs import GoFSStore
from repro_torch.gopher import GopherSession

from tests.conftest import TINY as J_TINY

TINY = GraphConfig(**dataclasses.asdict(J_TINY))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 300.0  # seconds: the longest any peer or worker is waited on
INF = float(np.inf)
# PageRank and the on-device mean against the reference: the tolerances
# of the ROADMAP's ground rules
PR_RTOL, PR_ATOL = 1e-5, 1e-7
MERGED_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_peers(fn, n=2, pkgs=None):
    """``fn(runtime)`` on ``n`` in-thread peers of one TCP exchange (each
    peer's runtime from the package in ``pkgs``, the port's by default);
    returns the results in process-id order, raising the first error."""
    pkgs = pkgs or [p_rt] * n
    port = free_port()
    out, errs = [None] * n, [None] * n

    def peer(pid):
        mod = pkgs[pid]
        try:
            if pid == 0:
                ex = mod.TcpExchange.listen(port, n, host="127.0.0.1",
                                            timeout=WAIT)
            else:
                ex = mod.TcpExchange.connect("127.0.0.1", port, pid, n,
                                             timeout=WAIT)
            rt = mod.ClusterRuntime(pid, n, exchange=ex)
            try:
                out[pid] = fn(rt)
            finally:
                rt.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs[pid] = e

    ts = [threading.Thread(target=peer, args=(i,), name=f"peer{i}")
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    for e in errs:
        if e is not None:
            raise e
    return out


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _held(got, ref, plus_mul, what="", merged=False):
    """A cluster result against the reference's single-process one:
    bitwise for min-plus; plus-mul within the tolerance the port holds
    to the reference, and an on-device mean (``merged``) within the
    port's rtol for it (the port's single-process results already
    differ from the reference's in the last bits there, ROADMAP ground
    rules)."""
    if merged:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=MERGED_RTOL,
                                   err_msg=str(what))
    elif plus_mul:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=PR_RTOL,
                                   atol=PR_ATOL, err_msg=str(what))
    else:
        _bits(got, ref, what)


# --------------------------------------------------------------- runtime

def test_shard_assignment_matches_reference():
    for n in range(1, 5):
        ex = None if n == 1 else object()  # only its presence is checked
        for P in range(n, 10):
            for pid in range(n):
                assert p_rt.shard_range(P, pid, n) == \
                    j_rt.shard_range(P, pid, n)
                prt = p_rt.ClusterRuntime(pid, n, exchange=ex)
                jrt = j_rt.ClusterRuntime(pid, n, exchange=ex)
                assert prt.partition_shard(P) == jrt.partition_shard(P)
                for part in range(P):
                    assert prt.shard_of_partition(part, P) == \
                        jrt.shard_of_partition(part, P)
    assert p_rt.ClusterRuntime(0, 1).partition_shard(5) == (0, 5)
    assert [p_rt.shard_range(7, i, 3) for i in range(3)] == \
        [(0, 3), (3, 5), (5, 7)]


MIXED = {"ref-root": [j_rt, p_rt], "port-root": [p_rt, j_rt]}


@pytest.mark.parametrize("order", sorted(MIXED))
def test_mixed_exchange_is_rank_ordered(order):
    """Reference and port processes share one exchange: every peer sees
    the same rank-ordered payloads, arrays included, and barriers pair."""
    def body(rt):
        out = []
        for i in range(3):
            out.append(rt.allgather(f"round/{i}",
                                    {"pid": rt.process_id, "i": i}))
            rt.barrier(f"b/{i}")
        lo = rt.process_id * 2
        cat = rt.allgather_concat(
            np.arange(lo, lo + 2, dtype=np.float32).reshape(2, 1),
            axis=0, tag="cat")
        return out, cat, rt.all_reduce_or(rt.process_id == 1, tag="v")

    r0, r1 = run_peers(body, pkgs=MIXED[order])
    assert r0[0] == r1[0]
    for i, parts in enumerate(r0[0]):
        assert parts == [{"pid": 0, "i": i}, {"pid": 1, "i": i}]
    for r in (r0, r1):
        _bits(r[1], np.arange(4, dtype=np.float32).reshape(4, 1))
        assert r[2] is True


@pytest.mark.parametrize("order", sorted(MIXED))
def test_mixed_exchange_tag_divergence_raises_on_both_sides(order):
    errs = []

    def body(rt):
        try:
            rt.allgather(f"tag-{rt.process_id}", 1)
        except (j_rt.ExchangeError, p_rt.ExchangeError) as e:
            errs.append(e)
            raise

    with pytest.raises((j_rt.ExchangeError, p_rt.ExchangeError)):
        run_peers(body, pkgs=MIXED[order])
    assert len(errs) == 2  # the root and the worker both failed fast


def test_check_consistent_and_exchange_counts():
    def body(rt):
        rt.check_consistent("same", ("span", 0))
        try:
            rt.check_consistent("chunk/0", ("span", rt.process_id))
        except p_rt.ExchangeError:
            return rt.exchange.stats()
        raise AssertionError("divergent digests passed")

    for st in run_peers(body):
        assert st["ops"] == 2 and st["bytes_sent"] > 0 \
            and st["bytes_received"] > 0


def test_single_process_runtime_is_inert():
    rt = p_rt.init_cluster(num_processes=1)
    assert not rt.is_distributed and rt.exchange is None
    assert rt.allgather("x", 3) == [3] and rt.all_reduce_or(True)
    assert cluster_comm(rt).name == "host" and cluster_comm(None).name == \
        "host"


# ------------------------------------------------------- gather backend

@pytest.mark.parametrize("sr", [MIN_PLUS, PLUS_MUL], ids=lambda s: s.name)
@pytest.mark.parametrize("Q", [None, 3])
@pytest.mark.parametrize("n", [2, 3])
def test_cluster_gather_matches_reference_fold(sr, Q, n):
    """The distributed combine is BITWISE the reference's host fold over
    the whole buffer, lane by lane under a query axis."""
    rng = np.random.default_rng(7)
    lead = () if Q is None else (Q,)
    buf = rng.random(lead + (5, 9), dtype=np.float32)
    if sr is MIN_PLUS:
        buf = np.where(rng.random(buf.shape) < 0.3, np.inf, buf)
        buf[..., 0, 0] = -0.0  # signed zeros fold as the reference's
        buf[..., 1, 0] = 0.0
    fold = j_fold_sum if sr is PLUS_MUL else j_fold_min
    want = np.stack([fold(b) for b in buf]) if Q else fold(buf)

    def body(rt):
        lo, hi = rt.partition_shard(5)
        return ClusterGather(runtime=rt).combine_boundary(
            torch.from_numpy(np.ascontiguousarray(buf[..., lo:hi, :])),
            sr).numpy()

    for got in run_peers(body, n=n):
        _bits(got, want, (sr.name, Q, n))


def test_lane_vote_is_an_elementwise_or():
    flags = {0: np.array([True, False, False, False]),
             1: np.array([False, False, True, False])}

    def body(rt):
        cg = ClusterGather(runtime=rt)
        return (cg.any_changed(flags[rt.process_id]),
                float(cg.sum_scalar(torch.tensor(rt.process_id + 0.5))))

    for lanes, total in run_peers(body):
        assert lanes.tolist() == [True, False, True, False]
        assert total == 2.0


# ------------------------------------------------------- shard fills

def _both_blocked(cfg):
    """(port bg, reference bg, (I, E) latencies, src) of one collection."""
    jcfg = type(J_TINY)(**dataclasses.asdict(cfg))
    col, jcol = generate_collection(cfg), j_generate(jcfg)
    t, jt = col.template, jcol.template
    bg = build_blocked(t, partition_graph(t, cfg.num_partitions,
                                          seed=cfg.seed), cfg.block_size)
    jbg = j_build_blocked(jt, j_partition_graph(
        jt, cfg.num_partitions, seed=cfg.seed), cfg.block_size)
    w = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    return bg, jbg, w.astype(np.float32), t.src


@pytest.mark.parametrize("cfg", [TINY, TR_TINY], ids=lambda c: c.name)
def test_shard_fills_bitwise_reference(cfg):
    bg, jbg, w, _ = _both_blocked(cfg)
    w = w.copy()
    w[:, ::5] = INF  # inactive edges: sparse tiles drop out
    P = bg.n_parts
    for parts in [(0, 1), (0, P // 2), (P // 2, P), (1, P)]:
        n = parts[1] - parts[0]
        for zero in (INF, 0.0):
            wz = np.where(np.isinf(w), zero, w).astype(np.float32)
            lt, bt = bg.alloc_batch_buffers(len(w), parts=parts)
            assert lt.shape[1] == bt.shape[1] == n
            _bits(bg.fill_local_batch(wz, zero=zero, out=lt, parts=parts),
                  jbg.fill_local_batch(wz, zero=zero, parts=parts))
            _bits(bg.fill_boundary_batch(wz, zero=zero, out=bt,
                                         parts=parts),
                  jbg.fill_boundary_batch(wz, zero=zero, parts=parts))
            _bits(bg.fill_local_batch(wz, zero=zero, parts=parts),
                  bg.fill_local_batch(wz, zero=zero)[:, parts[0]:parts[1]])
            got = bg.stage_sparse(wz, zero=zero, parts=parts)
            want = jbg.stage_sparse(wz, zero=zero, parts=parts)
            for f in ("tiles", "btiles", "rows", "cols", "brows", "bcols",
                      "nnz", "bnnz"):
                _bits(getattr(got, f), getattr(want, f), (parts, zero, f))
            # sparse fills into shard buffers, a full-width act sliced
            act_l, act_b = bg.active_tile_maps(wz, zero=zero)
            K = got.bucket
            out_l, _ = bg.alloc_batch_buffers(len(w), bucket=K,
                                              parts=parts)
            vals, rows, cols, nnz = bg.fill_local_batch_sparse(
                wz, zero=zero, bucket=K, out=out_l, act=act_l, parts=parts)
            _bits(vals, want.tiles)
            _bits(cols, want.cols)
            _bits(nnz, want.nnz)


@pytest.fixture(scope="module")
def tiny_store_root(tiny_collection, tmp_path_factory):
    """TINY deployed by the reference (both packages' stores open it)."""
    root = str(tmp_path_factory.mktemp("gofs_cluster"))
    j_deploy(tiny_collection, J_TINY, root)
    return root


def _attr(store):
    return next(n for n, a in store._e_attrs.items() if a.constant is None)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_shard_stream_matches_reference_fills(tiny_store_root, layout):
    store = GoFSStore(tiny_store_root)
    jstore = JGoFSStore(tiny_store_root)
    bg = GopherSession(store, device="cpu").bg
    jbg = JGopherSession(jstore).bg
    name = _attr(store)
    with shard_stream(store, bg, name, None, zero=INF,
                      layout=layout) as full:
        for _ in full:
            pass
        total = full.staged_bytes
    assert total > 0

    def body(rt):
        chunks = []
        with shard_stream(store, bg, name, rt, zero=INF,
                          chunk_instances=2, layout=layout) as st:
            for ch in st:
                chunks.append(ch)
            return st.staged_bytes, st.chunks, chunks

    P = bg.n_parts
    outs = run_peers(body)
    for pid, (nbytes, n_chunks, chunks) in enumerate(outs):
        assert n_chunks == len(chunks) > 0 and nbytes < total
        lo, hi = p_rt.shard_range(P, pid, 2)
        for ch in chunks:
            w = jstore.edge_attr_rows(name, range(ch.start,
                                                  ch.start + ch.count),
                                      parts=range(lo, hi), fill=INF,
                                      halo=True)
            if layout == "dense":
                _bits(ch.tiles, jbg.fill_local_batch(w, zero=INF,
                                                     parts=(lo, hi)))
                _bits(ch.btiles, jbg.fill_boundary_batch(
                    w, zero=INF, parts=(lo, hi)))
            else:
                want = jbg.stage_sparse(w, zero=INF, parts=(lo, hi))
                for f in ("tiles", "btiles", "rows", "cols", "brows",
                          "bcols", "nnz", "bnnz"):
                    _bits(getattr(ch, f), getattr(want, f), f)
    if layout == "dense":  # contiguous shards partition the tile bytes
        assert outs[0][0] + outs[1][0] == total


def test_shard_stream_span_divergence_raises(tiny_store_root):
    store = GoFSStore(tiny_store_root)
    bg = GopherSession(store, device="cpu").bg

    def body(rt):
        with shard_stream(store, bg, _attr(store), rt, zero=INF,
                          chunk_instances=1 + rt.process_id) as st:
            for _ in st:
                pass

    with pytest.raises(p_rt.ExchangeError):
        run_peers(body)


def test_shard_stream_binds_the_prefetcher(tiny_store_root):
    """``bind`` reaches the prefetcher: the engine's pool-thread hook runs
    on every shard chunk (on the card, its pinned ring fills them)."""
    store = GoFSStore(tiny_store_root)
    bg = GopherSession(store, device="cpu").bg
    st = shard_stream(store, bg, _attr(store), None, zero=INF)
    seen = []
    st.bind(None, lambda ch: seen.append(ch.start) or "ready")
    assert st.prefetcher.prepare is not None
    with st:
        assert all(ch.prepared == "ready" for ch in st)
    assert seen == [0, 2]
    st.bind()
    assert st.prefetcher.prepare is None and st.prefetcher.ring is None


# ------------------------------------------------------- engine parity

@pytest.fixture(scope="module")
def engine_env():
    bg, jbg, w, src = _both_blocked(TINY)
    col = generate_collection(TINY)
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    prw = edge_weights_for_instances(src, act, TINY.num_vertices)
    return dict(bg=bg, jbg=jbg, w=w, prw=prw, V=TINY.num_vertices)


ENGINE_CASES = {
    "sssp-sequential": dict(prog="sssp", pattern="sequential"),
    "pagerank-independent": dict(prog="pagerank", pattern="independent"),
    "sssp-warm": dict(prog="sssp", pattern="independent", warm=True),
    "sssp-3-sources": dict(prog="sssp3", pattern="independent"),
    "sssp-eventually-mean": dict(prog="sssp", pattern="eventually",
                                 merge="mean"),
}


def _programs(env, port=True):
    V = env["V"]
    if port:
        return {"sssp": T.min_plus_program("sssp", init=T.source_init(0)),
                "sssp3": T.min_plus_program(
                    "sssp", init=T.sources_init([0, 7, 42])),
                "pagerank": T.pagerank_program(V, iters=6)}
    return {"sssp": j_min_plus_program("sssp", init=j_source_init(0)),
            "sssp3": j_min_plus_program(
                "sssp", init=j_sources_init([0, 7, 42])),
            "pagerank": j_pagerank_program(V, iters=6)}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("n", [2, 3])
def test_cluster_engines_bitwise_single_process(engine_env, case, n):
    """N in-thread port engines (stacked per shard, ClusterGather) ==
    the single-process port engine, bitwise in values, final, supersteps
    and merged; and the reference's stacked engine, bitwise for min-plus
    (PageRank within its tolerance)."""
    c = ENGINE_CASES[case]
    w = engine_env["prw"] if c["prog"] == "pagerank" else engine_env["w"]
    kw = dict(pattern=c["pattern"], merge=c.get("merge"),
              warm_start=c.get("warm", False))
    prog = _programs(engine_env)[c["prog"]]
    one = T.TemporalEngine(engine_env["bg"], device="cpu").run(prog, w,
                                                               **kw)
    ref = JTemporalEngine(engine_env["jbg"]).run(
        _programs(engine_env, port=False)[c["prog"]], w, **kw)

    def body(rt):
        eng = T.TemporalEngine(engine_env["bg"], device="cpu", cluster=rt,
                               staging="async" if rt.process_id else "sync")
        assert eng.comm.name == "cluster"
        return eng.run(prog, w, **kw)

    pm = c["prog"] == "pagerank"
    for got in run_peers(body, n=n):
        for f in ("values", "final", "merged"):
            if getattr(one, f) is not None:
                _bits(getattr(got, f), getattr(one, f), (case, f))
                _held(getattr(got, f), getattr(ref, f), pm, (case, f),
                      merged=f == "merged")
        _bits(got.stats["supersteps"], one.stats["supersteps"], case)
        _bits(got.stats["supersteps"], np.asarray(ref.stats["supersteps"]),
              case)


def test_cluster_engine_slices_prestaged_and_sparse(engine_env):
    """Full-width pre-staged batches (dense tiles and a packed batch) are
    cut to each shard's partitions; a seed from ``resume_seed`` too."""
    bg, w = engine_env["bg"], engine_env["w"]
    prog = _programs(engine_env)["sssp"]
    one = T.TemporalEngine(bg, device="cpu")
    tiles, btiles = bg.fill_local_batch(w), bg.fill_boundary_batch(w)
    sp = bg.stage_sparse(w)
    want = one.run(prog, pattern="sequential", tiles=tiles, btiles=btiles)
    seed = one.resume_seed(want.final, pad=INF)
    tail = one.run(prog, w, pattern="sequential", x0=seed)

    def body(rt):
        eng = T.TemporalEngine(bg, device="cpu", cluster=rt)
        return (eng.run(prog, pattern="sequential", tiles=tiles,
                        btiles=btiles),
                eng.run(prog, pattern="sequential", sparse=sp),
                eng.run(prog, w, pattern="sequential",
                        x0=eng.resume_seed(want.final, pad=INF)))

    for dense, packed, resumed in run_peers(body):
        for got in (dense, packed):
            _bits(got.values, want.values)
            _bits(got.stats["supersteps"], want.stats["supersteps"])
        _bits(resumed.values, tail.values)
        _bits(resumed.final, tail.final)


# ------------------------------------------------------- session parity

SESSION_CASES = {
    "sssp": ("sssp", dict(source=0)),
    "pagerank": ("pagerank", dict(iters=5)),
    "components": ("components", {}),
    "sssp-warm": ("sssp", dict(source=0, pattern="independent", warm=True)),
    "sssp-3-sources": ("sssp", dict(source=[0, 7, 42])),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
@pytest.mark.parametrize("n", [2, 3])
def test_cluster_sessions_bitwise_single_process(tiny_store_root, case, n):
    """N in-thread port sessions (``cluster=rt``: shard-local streamed
    staging, ClusterGather) == the single-process port session, bitwise;
    and the reference's single-process session on the same deployment,
    bitwise for min-plus (PageRank within its tolerance)."""
    name, params = SESSION_CASES[case]
    sess = GopherSession(GoFSStore(tiny_store_root), device="cpu")
    one = sess.run(sess.plan(name, **params))
    jsess = JGopherSession(JGoFSStore(tiny_store_root))
    ref = jsess.run(jsess.plan(name, **params))

    def body(rt):
        s = GopherSession(GoFSStore(tiny_store_root), device="cpu",
                          cluster=rt)
        res = s.run(s.plan(name, **params))
        return res, s.last_run_report["staged_bytes"]

    single = sess.last_run_report["staged_bytes"]
    pm = name == "pagerank"
    for got, staged in run_peers(body, n=n):
        for f in ("values", "final"):
            _bits(getattr(got.engine, f), getattr(one.engine, f), (case, f))
            _held(getattr(got.engine, f), getattr(ref.engine, f), pm,
                  (case, f))
        for want in (one, ref):
            _bits(got.engine.stats["supersteps"],
                  np.asarray(want.engine.stats["supersteps"]), case)
        if name != "components":  # a materialized variant graph
            assert staged < single
        for k, v in one.output.items():
            if isinstance(v, np.ndarray):
                _bits(got.output[k], v, (case, k))


# ------------------------------------------------------- doctests

@pytest.mark.parametrize("modname", [
    "repro_torch.cluster.runtime", "repro_torch.cluster.gather",
    "repro_torch.cluster.checkpoint", "repro_torch.train.checkpoint"])
def test_cluster_docstring_examples_run(modname):
    """The examples in the cluster modules' docstrings run as written."""
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(modname))
    assert result.attempted > 0 and result.failed == 0, modname


# ------------------------------------------------- worker processes

@pytest.mark.parametrize("transport,apps", [("tcp", "sssp,pagerank"),
                                            ("torch", "sssp")])
def test_cluster_cli_workers_check_parity(tmp_path, transport, apps):
    """The CLI's own acceptance in REAL worker processes on the CPU:
    bitwise parity with the single-process run, per-host staged bytes
    below it; with the host lane alone, and beside a gloo process group
    (the control plane, ``--transport torch``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster_graph",
           "--num-processes", "2", "--apps", apps, "--transport", transport,
           "--size", "tiny", "--device", "cpu", "--check",
           "--deploy", str(tmp_path / "gofs"), "--out", str(tmp_path / "out"),
           "--timeout", str(WAIT)]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=2 * WAIT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "parity OK" in proc.stdout
