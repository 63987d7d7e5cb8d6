"""The port's delta tile chain against the JAX package's
(``tests/test_delta.py``'s deploy and load cases, on the port).

A slowly varying collection, generated by each package from one seed and
deployed with ``sparse_absent``, records the same chain in both (payload
pools, references, summary scalars, bitwise); the port's delta load
equals its full sparse load and the reference's, moving fewer bytes; a
stale or corrupt chain falls back to the full value slices in both
packages alike; and ``BlockedGraph``'s ``pack_payload_tiles``,
``active_tile_maps`` and ``sparse_buckets`` equal the reference's.

Streamed (``tests/test_delta.py``'s stream cases): delta chunks from
``load_blocked_stream`` equal the full load and the reference's chunks,
with the same deduped bytes; a stale chain streams from the value slices;
warm seeds staged asynchronously, the planner's delta and warm picks, the
session's streamed delta route and PageRank's row-wise stream equal the
reference.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.configs.base import GraphConfig as JGraphConfig
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.graph import TimeSeriesGraph as JTimeSeriesGraph
from repro.core.partition import partition_graph as j_partition_graph
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
from repro_torch.configs.base import GraphConfig
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.graph import TimeSeriesGraph
from repro_torch.core.partition import partition_graph
from repro_torch.gofs import GoFSStore, deploy_collection
from repro_torch.gofs import layout as port_layout
from repro_torch.gofs.layout import delta_slice_name, tile_map_name
from repro_torch.gofs.slices import read_array_slice, write_array_slice

CFG_KW = dict(
    name="delta", num_vertices=300, avg_degree=3.0, num_instances=6,
    num_partitions=3, block_size=32, instances_per_slice=2,
    bins_per_partition=2, cache_slots=4, seed=11,
)
CFG, J_CFG = GraphConfig(**CFG_KW), JGraphConfig(**CFG_KW)
INF = float(np.inf)
FIELDS = ("tiles", "btiles", "rows", "cols", "brows", "bcols", "nnz", "bnnz")


def _slowly_varying(gen, tsg_cls, cfg, monotone: bool = True):
    """tests/test_delta.py's collection: sparse, localized edge support
    with slowly tightening weights (one regression when not
    ``monotone``)."""
    col = gen(cfg, num_plates=6)
    I = len(col)
    src = np.asarray(col.template.src)
    dst = np.asarray(col.template.dst)
    rng = np.random.default_rng(0)
    live = (src < 40) & (dst < 40)
    w = np.where(live, np.asarray(col.edge_values(0, "latency"), np.float32),
                 np.float32(INF)).astype(np.float32)
    ws = [w]
    idx = np.nonzero(live)[0]
    for t in range(1, I):
        w = ws[-1].copy()
        band = rng.choice(idx, size=max(1, len(idx) // 8), replace=False)
        w[band] = (w[band] * 0.7).astype(np.float32)
        if not monotone and t == 2:
            w[idx[0]] = np.float32(ws[-1][idx[0]] * 3.0)
        ws.append(w)
    insts = []
    for t in range(I):
        gi = col.instances[t]
        ev = dict(gi.edge_values)
        ev["latency"] = ws[t]
        insts.append(dataclasses.replace(gi, edge_values=ev))
    return tsg_cls(template=col.template, instances=insts)


def _port_col(monotone=True):
    return _slowly_varying(generate_collection, TimeSeriesGraph, CFG,
                           monotone)


def _ref_col(monotone=True):
    return _slowly_varying(j_generate, JTimeSeriesGraph, J_CFG, monotone)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    col, jcol = _port_col(), _ref_col()
    root = str(tmp_path_factory.mktemp("port_delta"))
    jroot = str(tmp_path_factory.mktemp("ref_delta"))
    deploy_collection(col, CFG, root, sparse_absent={"latency": INF})
    j_deploy(jcol, J_CFG, jroot, sparse_absent={"latency": INF})
    tmpl, jtmpl = col.template, jcol.template
    bg = build_blocked(tmpl, partition_graph(tmpl, CFG.num_partitions,
                                             seed=CFG.seed), CFG.block_size)
    jbg = j_build_blocked(jtmpl, j_partition_graph(
        jtmpl, J_CFG.num_partitions, seed=J_CFG.seed), J_CFG.block_size)
    weights = np.stack([col.edge_values(t, "latency")
                        for t in range(len(col))]).astype(np.float32)
    return dict(col=col, root=root, jroot=jroot, bg=bg, jbg=jbg,
                weights=weights)


def _store(root, **kw):
    kw.setdefault("cache_slots", CFG.cache_slots)
    return GoFSStore(root, **kw)


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _eq_sparse(a, b):
    for f in FIELDS:
        _eq(getattr(a, f), getattr(b, f), f)


# ------------------------------------------------------------ deploy stats
def test_deploy_records_delta_chain(env):
    assert os.path.exists(os.path.join(
        env["root"], delta_slice_name("latency") + ".npz"))
    ratio, monotone = _store(env["root"]).delta_stats("latency", zero=INF)
    assert ratio is not None and 0.0 < ratio < 1.0  # real temporal reuse
    assert monotone is True
    assert _store(env["root"]).delta_stats("latency", zero=0.0) == \
        (None, None)


@pytest.mark.parametrize("name", ["delta", "tilemap"])
def test_chain_equals_the_references(env, name):
    """The port's deployment records the reference's chain and maps."""
    fname = delta_slice_name("latency") if name == "delta" \
        else tile_map_name("latency")
    a = read_array_slice(os.path.join(env["root"], fname))
    b = read_array_slice(os.path.join(env["jroot"], fname))
    assert list(a) == list(b)
    for k in b:
        _eq(a[k], b[k], k)


def test_non_monotone_collection_recorded(tmp_path):
    root, jroot = str(tmp_path / "port"), str(tmp_path / "ref")
    deploy_collection(_port_col(False), CFG, root,
                      sparse_absent={"latency": INF})
    j_deploy(_ref_col(False), J_CFG, jroot, sparse_absent={"latency": INF})
    ratio, monotone = _store(root).delta_stats("latency", zero=INF)
    assert ratio is not None and monotone is False
    assert (ratio, monotone) == \
        JGoFSStore(jroot).delta_stats("latency", zero=INF)


# ---------------------------------------------------------- load roundtrip
def test_delta_load_bitwise_matches_full(env):
    full = _store(env["root"]).load_blocked(env["bg"], "latency", zero=INF,
                                            layout="sparse", delta=False)
    dlt = _store(env["root"]).load_blocked(env["bg"], "latency", zero=INF,
                                           layout="sparse", delta=True)
    _eq_sparse(full, dlt)
    assert full.source_bytes is None  # full fill: nothing deduped
    assert dlt.source_bytes is not None
    assert dlt.source_bytes < dlt.staged_bytes()  # the dedupe paid off
    jdlt = JGoFSStore(env["jroot"], cache_slots=CFG.cache_slots).load_blocked(
        env["jbg"], "latency", zero=INF, layout="sparse", delta=True)
    _eq_sparse(dlt, jdlt)
    assert dlt.source_bytes == jdlt.source_bytes


def test_delta_survives_c0_cache(env):
    store = _store(env["root"], cache_slots=0)  # c0 disables value caching
    full = store.load_blocked(env["bg"], "latency", zero=INF,
                              layout="sparse", delta=False)
    dlt = store.load_blocked(env["bg"], "latency", zero=INF, layout="sparse")
    _eq(full.tiles, dlt.tiles)
    assert dlt.source_bytes is not None  # chain pinned past slots=0
    assert store.cache.stats()["pinned"] >= 2  # tile map + delta pool


# ------------------------------------------------------------- fallbacks
def _corrupt(root, **overrides):
    path = os.path.join(root, delta_slice_name("latency"))
    arrs = read_array_slice(path)
    arrs.update(overrides)
    write_array_slice(path, arrs)


MUTATIONS = ["refs_out_of_range", "wrong_block", "truncated_pool",
             "missing_file", "wrong_absent", "unreadable"]


def _mutated_root(env, tmp_path, mutation):
    """A fresh deployment of the collection whose chain is made stale or
    corrupt by ``mutation``."""
    droot = str(tmp_path / "gofs")
    deploy_collection(env["col"], CFG, droot,
                      sparse_absent={"latency": INF})
    path = os.path.join(droot, delta_slice_name("latency") + ".npz")
    if mutation == "refs_out_of_range":
        bad = read_array_slice(path)["ref_local"].copy()
        bad[bad >= 0] = 10 ** 6  # points past the payload pool
        _corrupt(droot, ref_local=bad)
    elif mutation == "wrong_block":
        _corrupt(droot, block_size=np.asarray(CFG.block_size * 2))
    elif mutation == "truncated_pool":
        _corrupt(droot, payloads_local=read_array_slice(path)
                 ["payloads_local"][:1])
    elif mutation == "wrong_absent":
        _corrupt(droot, absent=np.asarray(0.0, np.float64))
    elif mutation == "unreadable":
        with open(path, "r+b") as f:
            f.truncate(64)
    else:
        os.remove(path)
    return droot


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_stale_or_corrupt_delta_falls_back_to_full(env, tmp_path, mutation):
    """A stale or corrupt chain: the load takes the full value slices and
    gives the full fill, in the port as in the reference."""
    droot = _mutated_root(env, tmp_path, mutation)
    out = _store(droot).load_blocked(env["bg"], "latency", zero=INF,
                                     layout="sparse", delta=True)
    ref = _store(env["root"]).load_blocked(env["bg"], "latency", zero=INF,
                                           layout="sparse", delta=False)
    _eq_sparse(out, ref)
    assert out.source_bytes is None  # fell back to the full fill
    jout = JGoFSStore(droot, cache_slots=CFG.cache_slots).load_blocked(
        env["jbg"], "latency", zero=INF, layout="sparse", delta=True)
    _eq_sparse(out, jout)
    assert jout.source_bytes is None


def test_delta_chain_rejects_foreign_blocking(env):
    # same collection re-blocked differently: recorded chain must refuse
    tmpl = env["col"].template
    bg2 = build_blocked(tmpl, partition_graph(tmpl, 2, seed=99),
                        CFG.block_size)
    out = _store(env["root"]).load_blocked(bg2, "latency", zero=INF,
                                           layout="sparse", delta=True)
    _eq(out.tiles, bg2.stage_sparse(env["weights"], zero=INF).tiles)
    assert out.source_bytes is None


# ------------------------------------------------ deploy's payload interning
def test_tile_pool_dedups_exact_bytes():
    """Tiles share a payload iff their bytes are equal: -0.0 and 0.0 are
    two payloads, one NaN pattern is one payload; ids follow first
    appearance."""
    pool = port_layout._TilePool(8, 2)
    z, nz = np.zeros((2, 2), np.float32), np.full((2, 2), -0.0, np.float32)
    nan = np.full((2, 2), np.nan, np.float32)
    ids = [pool.intern(t) for t in (z, nz, nan, z, nan.copy(), nz)]
    assert ids == [0, 1, 2, 0, 2, 1]
    assert len(pool) == 3
    _eq(np.concatenate(pool.parts()).view(np.uint32),
        np.stack([z, nz, nan]).view(np.uint32))


def test_digest_collisions_keep_the_chain_exact(env, tmp_path, monkeypatch):
    """With every tile under one digest, the full-byte comparison alone
    decides: the deployment still equals the reference's."""

    class _OneDigest:
        def __init__(self, *_a, **_k):
            pass

        def digest(self):
            return b"same"

    monkeypatch.setattr(port_layout.hashlib, "blake2b", _OneDigest)
    root = str(tmp_path / "collide")
    deploy_collection(env["col"], CFG, root, sparse_absent={"latency": INF})
    for fname in (delta_slice_name("latency"), tile_map_name("latency")):
        a = read_array_slice(os.path.join(root, fname))
        b = read_array_slice(os.path.join(env["jroot"], fname))
        for k in b:
            _eq(a[k], b[k], k)


# --------------------------------------------- BlockedGraph methods it needs
@pytest.mark.parametrize("zero", [INF, 0.0], ids=["min_plus", "plus_mul"])
def test_blocked_methods_match_reference(env, zero):
    bg, jbg, w = env["bg"], env["jbg"], env["weights"]
    for got, want in zip(bg.active_tile_maps(w, zero),
                         jbg.active_tile_maps(w, zero)):
        _eq(got, want)
    for got, want in zip(bg.active_tile_maps(w[0], zero),
                         jbg.active_tile_maps(w[0], zero)):
        _eq(got, want)
    assert bg.sparse_buckets(w, zero) == jbg.sparse_buckets(w, zero)
    rng = np.random.default_rng(3)
    B = bg.block_size
    for rc, t_max in ((bg.tiles_rc, bg.t_max), (bg.btiles_rc, bg.tb_max)):
        pay = rng.random((7, B, B)).astype(np.float32)
        ref = rng.integers(-1, 7, (len(w), bg.n_parts, t_max)).astype(
            np.int64)
        ref[:, :, t_max // 2:] = -1
        for bucket in (None, 64):
            got = bg.pack_payload_tiles(ref, pay, rc, zero, bucket=bucket)
            want = jbg.pack_payload_tiles(ref, pay, rc, zero, bucket=bucket)
            for a, b in zip(got, want):
                _eq(a, b)


# ------------------------------------------------------------ streamed
def _stream(root, bg, **kw):
    with _store(root).load_blocked_stream(bg, "latency", zero=INF,
                                          layout="sparse", **kw) as pf:
        return list(pf)


def _cat(chunks, f):
    return np.concatenate([getattr(c, f) for c in chunks])


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_delta_stream_bitwise_matches_full(env, chunk):
    """Streamed delta chunks (stream-wide buckets from the refs) equal the
    full sparse load and the reference's stream chunk for chunk, and
    report the deduped bytes."""
    full = _store(env["root"]).load_blocked(env["bg"], "latency", zero=INF,
                                            layout="sparse", delta=False)
    got = _stream(env["root"], env["bg"], delta=True, chunk_instances=chunk)
    with JGoFSStore(env["jroot"], cache_slots=CFG.cache_slots
                    ).load_blocked_stream(env["jbg"], "latency", zero=INF,
                                          layout="sparse", delta=True,
                                          chunk_instances=chunk) as jpf:
        want = list(jpf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            _eq(getattr(g, f), getattr(w, f), f)
        assert g.staged_bytes is not None
        assert g.staged_bytes == w.staged_bytes
    for f in FIELDS:
        _eq(_cat(got, f), getattr(full, f), f)
    assert sum(c.staged_bytes for c in got) < full.staged_bytes()


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_stale_or_corrupt_delta_stream_falls_back(env, tmp_path, mutation):
    """The stream half of the fallback cases: a stale or corrupt chain
    streams from the full value slices (no chunk reports deduped bytes),
    equal to the full load."""
    droot = _mutated_root(env, tmp_path, mutation)
    got = _stream(droot, env["bg"], delta=True, chunk_instances=2)
    ref = _store(env["root"]).load_blocked(env["bg"], "latency", zero=INF,
                                           layout="sparse", delta=False)
    assert all(c.staged_bytes is None for c in got)
    for f in FIELDS:
        _eq(_cat(got, f), getattr(ref, f), f)


def test_warm_start_streamed_parity(env):
    """A warm-started run staged asynchronously equals the cold sync run
    (the collection is monotone-improving) and the reference's warm
    async run, supersteps included."""
    import repro.core.engine as J
    import repro_torch.core.engine as T

    w = env["weights"]
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    eng = T.TemporalEngine(env["bg"], device="cpu")
    cold = eng.run(prog, w, pattern="independent")
    warm = eng.run(prog, w, pattern="independent", warm_start=True,
                   staging="async")
    _eq(cold.values, warm.values)
    assert warm.warm_start and eng.last_stream_report["chunks"] == 3
    jwarm = J.TemporalEngine(env["jbg"]).run(
        J.min_plus_program("sssp", init=J.source_init(0)), w,
        pattern="independent", warm_start=True, staging="async")
    _eq(warm.values, jwarm.values)
    for k in ("supersteps", "local_sweeps"):
        _eq(warm.stats[k], jwarm.stats[k], k)


def _sessions(env):
    from repro.gofs import GoFSStore as JStore
    from repro.gopher import GopherSession as JSession
    from repro_torch.gopher import GopherSession

    return (GopherSession(_store(env["root"]), device="cpu"),
            JSession(JStore(env["jroot"], cache_slots=CFG.cache_slots)))


def test_planner_auto_selects_delta_and_warm(env):
    """On a monotone slowly varying collection both planners pick the
    sparse layout, the delta route and warm seeds, for the same reasons
    and estimates."""
    sess, jsess = _sessions(env)
    p = sess.plan("sssp", source=0, pattern="independent")
    j = jsess.plan("sssp", source=0, pattern="independent")
    assert p.layout.value == "sparse"
    assert p.delta.value is True and p.delta.source == "auto"
    assert p.warm.value is True and p.warm.source == "auto"
    for f in ("layout", "comm", "staging", "delta", "warm", "placement"):
        a, b = getattr(p, f), getattr(j, f)
        assert (a.value, a.source, a.reason) == (b.value, b.source,
                                                 b.reason), f
    assert p.estimates == j.estimates and p.params == j.params
    assert p.kernel.value == j.kernel.value == "off"


def test_session_delta_warm_end_to_end(env):
    """The auto plan (streamed delta chunks, warm seeds) equals the
    reference's run and the port's cold full-route run; its staged bytes
    are the deduped bytes, as in the reference's report."""
    sess, jsess = _sessions(env)
    auto = sess.run(sess.plan("sssp", source=0, pattern="independent"))
    rep = dict(sess.last_run_report)
    jauto = jsess.run(jsess.plan("sssp", source=0, pattern="independent"))
    assert rep == jsess.last_run_report
    _eq(auto.engine.values, jauto.engine.values)
    for k in ("supersteps", "local_sweeps"):
        _eq(auto.engine.stats[k], jauto.engine.stats[k], k)
    sess2, _ = _sessions(env)
    cold = sess2.run(sess2.plan("sssp", source=0, pattern="independent",
                                delta=False, warm=False))
    _eq(auto.engine.values, cold.engine.values)
    assert auto.engine.warm_start and not cold.engine.warm_start
    assert rep["staged_bytes"] < sess2.last_run_report["staged_bytes"]


def test_rowwise_transform_streams_async(env):
    """PageRank's row-wise transform streams on the prefetch pool: one
    staging pass, equal to the sync (materialized) plan bitwise and to the
    reference within rtol 1e-5 / atol 1e-7."""
    sess, jsess = _sessions(env)
    plan = sess.plan("pagerank")
    assert plan.staging.value == "async"
    got = sess.run(plan)
    assert sess.last_run_report["staging_passes"] == 1
    sess2, _ = _sessions(env)
    ref = sess2.run(sess2.plan("pagerank", staging="sync"))
    _eq(got.output["ranks"], ref.output["ranks"])
    want = jsess.run(jsess.plan("pagerank"))
    assert sess.last_run_report == jsess.last_run_report
    np.testing.assert_allclose(got.output["ranks"],
                               np.asarray(want.output["ranks"]),
                               rtol=1e-5, atol=1e-7)
