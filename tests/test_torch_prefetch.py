"""The port's SlicePrefetcher and async engine staging against the JAX
package's (``tests/test_prefetch.py``'s cases, on the port).

The double-buffered GoFS read pipeline must be invisible in the results:
chunks equal the reference's chunks array for array, async and streamed
runs equal sync runs and the reference bitwise on all three iBSP
patterns, and cancellation is clean (no leaked threads; depth 1 makes no
thread).  The pinned ring that CUDA passes fill is driven here with
host buffers and stand-in events: a buffer is never handed out again
before the event of the copy that read it has completed.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.core.algorithms import pagerank as j_pagerank
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.partition import partition_graph as j_partition_graph
from repro.gofs import GoFSStore as JGoFSStore
import repro_torch.core.engine as T
from repro_torch.configs.base import GraphConfig
from repro_torch.core.algorithms import pagerank
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.gofs import GoFSStore
from repro_torch.gofs import prefetch as P
from repro_torch.gofs.prefetch import THREAD_PREFIX, SlicePrefetcher

from tests.conftest import TINY as J_TINY

TINY = GraphConfig(**dataclasses.asdict(J_TINY))
INF = float(np.inf)
CHUNK_FIELDS = ("start", "count", "tiles", "btiles", "rows", "cols",
                "brows", "bcols", "nnz", "bnnz", "staged_bytes")


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tiny_collection, tiny_gofs):
    """TINY in both packages, and the reference conftest's plain
    deployment, opened by both stores."""
    col = generate_collection(TINY, num_plates=6)
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(
        tmpl, TINY.num_partitions, seed=TINY.seed), TINY.block_size)
    jt = tiny_collection.template
    jbg = j_build_blocked(jt, j_partition_graph(
        jt, J_TINY.num_partitions, seed=J_TINY.seed), J_TINY.block_size)
    I = len(col)
    w = np.stack([col.edge_values(t, "latency") for t in range(I)])
    act = np.stack([col.edge_values(t, "active") for t in range(I)])
    return dict(tmpl=tmpl, bg=bg, jbg=jbg, w=w, act=act, root=tiny_gofs,
                store=GoFSStore(tiny_gofs, cache_slots=TINY.cache_slots),
                jstore=JGoFSStore(tiny_gofs, cache_slots=TINY.cache_slots))


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in CHUNK_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if a is None or b is None or np.isscalar(a):
                assert a == b, f
            else:
                _eq(a, b, f)


def _same_run(got, want):
    for f in ("values", "final"):
        _eq(getattr(got, f), np.asarray(getattr(want, f)), f)
    for k in ("supersteps", "local_sweeps"):
        _eq(got.stats[k], np.asarray(want.stats[k]), k)


# ---------------------------------------------------------------- staging
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fill_batch_out_buffer_in_place(env, layout):
    """``out=`` fills (and ``alloc_batch_buffers``) equal the reference's
    fills bitwise, in place over stale data."""
    bg, jbg, w = env["bg"], env["jbg"], env["w"]
    if layout == "dense":
        want_l, want_b = jbg.fill_local_batch(w), jbg.fill_boundary_batch(w)
        buf_l, buf_b = bg.alloc_batch_buffers(w.shape[0])
        jl, jb = jbg.alloc_batch_buffers(w.shape[0])
        assert (buf_l.shape, buf_b.shape) == (jl.shape, jb.shape)
        buf_l[...] = buf_b[...] = -7.0  # stale data from a previous pass
        got_l = bg.fill_local_batch(w, out=buf_l)
        got_b = bg.fill_boundary_batch(w, out=buf_b)
    else:
        kb, kbb = jbg.sparse_buckets(w)
        buf_l, buf_b = bg.alloc_batch_buffers(w.shape[0], bucket=kb,
                                              bbucket=kbb)
        buf_l[...] = buf_b[...] = -7.0
        got = bg.fill_local_batch_sparse(w, bucket=kb, out=buf_l)
        gotb = bg.fill_boundary_batch_sparse(w, bucket=kbb, out=buf_b)
        want = jbg.fill_local_batch_sparse(w, bucket=kb)
        wantb = jbg.fill_boundary_batch_sparse(w, bucket=kbb)
        for a, b in zip(got + gotb, want + wantb):
            _eq(a, b)
        got_l, got_b, want_l, want_b = got[0], gotb[0], want[0], wantb[0]
    _eq(got_l, want_l)
    _eq(got_b, want_b)
    assert np.shares_memory(got_l, buf_l) and np.shares_memory(got_b, buf_b)


def test_pack_payload_tiles_out_buffer(env):
    bg, jbg, w = env["bg"], env["jbg"], env["w"]
    rng = np.random.default_rng(3)
    act_l, _ = bg.active_tile_maps(w)
    pay = rng.random((int(act_l.sum()), bg.block_size, bg.block_size),
                     dtype=np.float32)
    ref = np.full(act_l.shape, -1, np.int32)
    ref[act_l] = np.arange(int(act_l.sum())) % max(1, len(pay) // 2)
    want = jbg.pack_payload_tiles(ref, pay, jbg.tiles_rc, INF)
    K = want[0].shape[2]
    buf, _ = bg.alloc_batch_buffers(w.shape[0], bucket=K)
    buf[...] = -7.0
    got = bg.pack_payload_tiles(ref, pay, bg.tiles_rc, INF, bucket=K,
                                out=buf)
    for a, b in zip(got, want):
        _eq(a, b)
    assert np.shares_memory(got[0], buf)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_stream_chunks_match_reference(env, depth, layout):
    """Chunks equal the reference's stream chunk for chunk, and their
    concatenation equals the bulk load."""
    kw = dict(prefetch_depth=depth, chunk_instances=2, layout=layout)
    with env["store"].load_blocked_stream(env["bg"], "latency", **kw) as pf:
        got = list(pf)  # chunk-owned buffers: safe to hold
    with env["jstore"].load_blocked_stream(env["jbg"], "latency",
                                           **kw) as jpf:
        want = list(jpf)
    _same_chunks(got, want)
    assert [c.start for c in got] == list(range(0, len(env["w"]), 2))
    if layout == "dense":
        tiles, btiles = env["store"].load_blocked(env["bg"], "latency")
        _eq(np.concatenate([c.tiles for c in got]), tiles)
        _eq(np.concatenate([c.btiles for c in got]), btiles)
    assert _prefetch_threads() == []


def test_transform_and_stage_fn(env):
    """``transform=`` runs row-wise on the pool thread (PageRank's
    outdegree weights, equal to the reference's); ``stage_fn`` replaces
    the read and fill and gets the chunk's buffer allocator."""
    tmpl, bg = env["tmpl"], env["bg"]
    V = tmpl.num_vertices

    def tf(rows):
        return pagerank.edge_weights_for_instances(tmpl.src, rows, V)

    def jtf(rows):
        return j_pagerank.edge_weights_for_instances(tmpl.src, rows, V)

    with env["store"].load_blocked_stream(bg, "active", zero=0.0,
                                          transform=tf) as pf:
        got = list(pf)
    with env["jstore"].load_blocked_stream(env["jbg"], "active", zero=0.0,
                                           transform=jtf) as jpf:
        want = list(jpf)
    _same_chunks(got, want)

    calls = []

    def stage(s, e, alloc):
        out_l, out_b = alloc(e - s)
        calls.append((s, e))
        w = env["w"][s:e]
        return P.StagedChunk(
            start=s, count=e - s,
            tiles=bg.fill_local_batch(w, out=out_l),
            btiles=bg.fill_boundary_batch(w, out=out_b))

    pf = SlicePrefetcher(bg, None, len(env["w"]), zero=INF,
                         chunk_instances=2, stage_fn=stage)
    chunks = list(pf)
    assert calls == [(0, 2), (2, 3)]
    _eq(np.concatenate([c.tiles for c in chunks]),
        bg.fill_local_batch(env["w"]))


# ------------------------------------------------------- engine parity
def test_async_staging_bitwise_parity_all_patterns(env):
    """TemporalEngine(staging="async") == sync staging == the reference's
    async staging, bit for bit, on sequential / independent / eventually
    (merged within rtol 1e-6 of the reference, bitwise to sync)."""
    bg, jbg, w, tmpl = env["bg"], env["jbg"], env["w"], env["tmpl"]
    sync = T.TemporalEngine(bg, device="cpu")
    async_ = T.TemporalEngine(bg, device="cpu", staging="async",
                              chunk_instances=1)
    jasync = J.TemporalEngine(jbg, staging="async", chunk_instances=1)
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    jprog = J.min_plus_program("sssp", init=J.source_init(0))
    for pattern in ("sequential", "independent"):
        a = sync.run(prog, w, pattern=pattern)
        b = async_.run(prog, w, pattern=pattern)
        _same_run(b, a)
        _same_run(b, jasync.run(jprog, w, pattern=pattern))
        assert async_.last_stream_report["chunks"] == len(w)
    pw = pagerank.edge_weights_for_instances(tmpl.src, env["act"],
                                             tmpl.num_vertices)
    pp = T.pagerank_program(tmpl.num_vertices, iters=8)
    a = sync.run(pp, pw, pattern="eventually", merge="mean")
    b = async_.run(pp, pw, pattern="eventually", merge="mean")
    _eq(a.values, b.values)
    _eq(a.merged, b.merged)
    j = jasync.run(J.pagerank_program(tmpl.num_vertices, iters=8), pw,
                   pattern="eventually", merge="mean")
    np.testing.assert_allclose(b.values, np.asarray(j.values), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(b.merged, np.asarray(j.merged), rtol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_async_parity_many_chunks_in_flight(env, layout):
    """Many more chunks than the prefetch window: the CPU engine aliases
    each chunk's buffers, so a chunk must stay untouched after handoff."""
    bg, w = env["bg"], env["w"]
    w9 = np.concatenate([w, w * 2.0, w * 3.0])  # I=9
    sync = T.TemporalEngine(bg, device="cpu", layout=layout)
    async_ = T.TemporalEngine(bg, device="cpu", staging="async",
                              prefetch_depth=2, chunk_instances=1,
                              layout=layout)
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    for pattern in ("sequential", "independent"):
        a = sync.run(prog, w9, pattern=pattern)
        b = async_.run(prog, w9, pattern=pattern)
        _same_run(b, a)
        assert a.occupancy == b.occupancy


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_gofs_stream_engine_matches_sync(env, layout):
    """Disk path: the engine consuming load_blocked_stream chunks equals
    the one-shot load_blocked staging and the reference's stream run."""
    bg, store = env["bg"], env["store"]
    eng = T.TemporalEngine(bg, device="cpu")
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    batch = store.load_blocked(bg, "latency", layout=layout)
    if layout == "dense":
        a = eng.run(prog, tiles=batch[0], btiles=batch[1],
                    pattern="sequential")
    else:
        a = eng.run(prog, sparse=batch, pattern="sequential")
    b = eng.run(prog, pattern="sequential", stream=store.load_blocked_stream(
        bg, "latency", layout=layout))
    _same_run(b, a)
    assert a.occupancy == b.occupancy
    jb = J.TemporalEngine(env["jbg"]).run(
        J.min_plus_program("sssp", init=J.source_init(0)),
        pattern="sequential", stream=env["jstore"].load_blocked_stream(
            env["jbg"], "latency", layout=layout))
    _same_run(b, jb)
    assert b.occupancy == jb.occupancy
    assert _prefetch_threads() == []  # pool joined at stream exhaustion


def test_streamed_chunks_skip_the_device_cache(env):
    """A streamed run leaves nothing in the engine's staged-batch cache
    (every instance's tiles would otherwise stay resident)."""
    bg, store = env["bg"], env["store"]
    eng = T.TemporalEngine(bg, device="cpu")
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    for layout in ("dense", "sparse"):
        eng.run(prog, pattern="independent",
                stream=store.load_blocked_stream(bg, "latency",
                                                 layout=layout))
        assert len(eng._staged_device) == 0
    rep = eng.last_stream_report
    assert rep["chunks"] == 2 and rep["instances"] == 3
    assert rep["compute_clock"] == "host"


# ------------------------------------------------ depth/cancel semantics
def test_depth1_is_synchronous_no_threads(env):
    pf = env["store"].load_blocked_stream(env["bg"], "latency",
                                          prefetch_depth=1,
                                          chunk_instances=1)
    seen = 0
    for _ in pf:
        assert _prefetch_threads() == []  # no pool in degenerate mode
        seen += 1
    assert seen == env["store"].num_timesteps()


def test_close_mid_stream_no_leaked_threads(env):
    pf = env["store"].load_blocked_stream(env["bg"], "latency",
                                          prefetch_depth=3,
                                          chunk_instances=1)
    it = iter(pf)
    assert next(it).start == 0
    assert _prefetch_threads() != []  # pool live mid-stream
    pf.close()
    assert _prefetch_threads() == []
    assert list(it) == []  # cancelled stream yields nothing further


def test_close_from_another_thread(env):
    """close() may race the consumer's own submits: the pool/pending
    handoff is locked, so a close from outside must neither crash the
    consumer nor leak."""
    pf = env["store"].load_blocked_stream(env["bg"], "latency",
                                          prefetch_depth=2,
                                          chunk_instances=1)
    done = threading.Event()
    seen = []
    it = iter(pf)
    seen.append(next(it).start)

    def closer():
        pf.close()
        done.set()

    t = threading.Thread(target=closer)
    t.start()
    for ch in it:  # either ends early or finishes; must not raise
        seen.append(ch.start)
    t.join(timeout=10)
    assert done.is_set()
    assert _prefetch_threads() == []
    assert seen == sorted(set(seen))  # in-order, no duplicates


def test_prefetcher_reiterates_after_close(env):
    pf = env["store"].load_blocked_stream(env["bg"], "latency",
                                          prefetch_depth=2,
                                          chunk_instances=2)
    it = iter(pf)
    next(it)
    pf.close()
    counts = [c.count for c in pf]  # fresh pass after cancel
    assert sum(counts) == env["store"].num_timesteps()
    assert _prefetch_threads() == []


# ---------------------------------------------------- the pinned ring
class _Event:
    """Stands in for a CUDA event: like a copy on a side stream, it
    completes on its own, ``delay`` seconds after it was recorded."""

    def __init__(self, delay):
        self._at = time.perf_counter() + delay

    def query(self):
        return time.perf_counter() >= self._at

    def synchronize(self):
        time.sleep(max(0.0, self._at - time.perf_counter()))


@pytest.fixture
def host_ring(monkeypatch):
    """A PinnedRing over ordinary host buffers (the CPU has no pinning)."""
    monkeypatch.setattr(P, "_pin", lambda n: np.empty(max(1, n), np.uint8))
    monkeypatch.setattr(P, "_unpin", lambda buf: None)
    return P.PinnedRing()


@pytest.mark.parametrize("depth,inflight", [(2, 1), (3, 1), (2, 2)])
def test_ring_reuses_a_buffer_only_after_its_copy(env, host_ring, depth,
                                                  inflight):
    """Slow copies: each chunk's buffer is released with an event that
    completes only 50 ms later.  The producer runs ahead meanwhile, and
    must not refill the buffer before then (the chunk's bytes stay as
    handed over until the event completes); the ring holds at most
    window + 2 buffers, and the chunks equal an unpinned pass."""
    bg, w = env["bg"], env["w"]
    w8 = np.concatenate([w, w * 2.0, w * 3.0])[:8]
    want = list(SlicePrefetcher.from_weights(bg, w8, zero=INF,
                                             chunk_instances=1))
    pf = SlicePrefetcher.from_weights(bg, w8, zero=INF, chunk_instances=1,
                                      prefetch_depth=depth,
                                      inflight=inflight)
    pf.ring = host_ring
    for k, ch in enumerate(pf):
        assert ch.lease is not None
        _eq(ch.tiles, want[k].tiles)
        _eq(ch.btiles, want[k].btiles)
        view = (ch.tiles, ch.btiles)
        ev = _Event(0.05)
        ch.release(ev)
        del ch
        while not ev.query():  # the copy is still reading the buffer
            _eq(view[0], want[k].tiles)
            _eq(view[1], want[k].btiles)
            time.sleep(0.005)
        assert len(host_ring._slots) <= pf.window + 2
    assert _prefetch_threads() == []
    assert host_ring.peak_bytes > 0


def test_ring_returns_unconsumed_chunks_on_close(env, host_ring):
    bg, w = env["bg"], env["w"]
    pf = SlicePrefetcher.from_weights(bg, np.concatenate([w, w]), zero=INF,
                                      chunk_instances=1, prefetch_depth=3)
    pf.ring = host_ring
    it = iter(pf)
    first = next(it)
    pf.close()
    first.release()
    assert _prefetch_threads() == []
    assert all(not s.leased for s in host_ring._slots)
    # a fresh pass reuses the buffers
    n = len(host_ring._slots)
    for ch in pf:
        ch.release()
    assert len(host_ring._slots) <= max(n, pf.window + 2)


def test_engine_binds_no_ring_on_the_cpu(env):
    """On the CPU chunks own ordinary buffers and the engine aliases them;
    the prefetcher is left unbound after the run."""
    pf = env["store"].load_blocked_stream(env["bg"], "latency")
    T.TemporalEngine(env["bg"], device="cpu").run(
        T.min_plus_program("sssp", init=T.source_init(0)),
        pattern="sequential", stream=pf)
    assert pf.ring is None and pf.prepare is None
    assert P._RINGS == {}
