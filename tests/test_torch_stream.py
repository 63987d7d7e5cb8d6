"""The port's streaming ingestion against the JAX package's.

* ``append_instances``: the port's and the reference's appends of the
  same instances to the same prefix deployment leave the same files,
  arrays (keys and order) and JSON — on the fast path (the recorded pool
  rehydrated, new tiles interning against its ids) and on the full
  rebuild a stale tile map or a torn delta slice forces; a deployment
  grown by either package loads bitwise in the other.
* ``tests/test_delta.py``'s ``grown_env`` cases on the port: the grown
  chain serves, torn or stale appended slices fall back, a torn manifest
  keeps the reader at its version.
* ``tests/test_parity_properties.py``'s streaming property on the port:
  deploy a prefix, append in random batches, ``tail`` after each append;
  every ``TailUpdate`` (mode, new instances, version, outputs, stats)
  equals the reference session's on the same store, and the last one a
  cold run on the grown store.  Seeds 0-2 fixed, then a hypothesis
  property of 5 examples.
* ``TemporalEngine.resume_seed`` at (V,) and (Q, V); session ``refresh``:
  the cache keys kept and dropped and ``staging_cache_stats()`` field by
  field against the reference's, the extended staged batch bitwise.

Min-plus results are compared bit for bit (``_bits``: -0 is not +0);
PageRank within rtol 1e-5 / atol 1e-7.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core.engine import TemporalEngine as JTemporalEngine
from repro.core.graph import TimeSeriesGraph as JTimeSeriesGraph
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import append_instances as j_append
from repro.gofs import deploy_collection as j_deploy
from repro.gopher import GopherSession as JGopherSession
from repro_torch.core.engine import TemporalEngine
from repro_torch.core.graph import TimeSeriesGraph
from repro_torch.gofs import GoFSStore, append_instances, deploy_collection
from repro_torch.gofs.layout import delta_slice_name, tile_map_name
from repro_torch.gofs.slices import (
    read_array_slice, read_json_slice, write_array_slice)
from repro_torch.gopher import GopherSession

from tests.conftest import given, hyp_st, settings
from tests.test_parity_properties import _streaming_case
from tests.test_torch_delta import CFG, J_CFG, _port_col, _ref_col

INF = float(np.inf)
PR_RTOL, PR_ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a, b, what=""):
    """Equal dtype, shape and bits (float32 compared as uint32)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert np.array_equal(a, b), what


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_deployment(root, jroot):
    """Same file names, equal JSON, and every npz slice with the same keys
    in the same order and bitwise-equal arrays."""
    files = _files(jroot)
    assert files == _files(root)
    for f in files:
        if f.endswith(".json"):
            assert read_json_slice(os.path.join(root, f)) == \
                read_json_slice(os.path.join(jroot, f)), f
            continue
        a = read_array_slice(os.path.join(root, f))
        b = read_array_slice(os.path.join(jroot, f))
        assert list(a) == list(b), f
        for k in b:
            _bits(a[k], b[k], f"{f}[{k}]")


def _part(col, lo, hi):
    return TimeSeriesGraph(template=col.template,
                           instances=col.instances[lo:hi])


def _jpart(col, lo, hi):
    return JTimeSeriesGraph(template=col.template,
                            instances=col.instances[lo:hi])


@pytest.fixture(scope="module")
def cols():
    return _port_col(), _ref_col()


def _grow_both(cols, tmp_path, splits, sparse=True, damage=None):
    """Deploy ``splits[0]`` instances with each package, then append the
    next batches with each; ``damage(root)`` runs on both roots before
    the appends.  Returns (port root, reference root)."""
    col, jcol = cols
    kw = {"sparse_absent": {"latency": INF}} if sparse else {}
    root, jroot = str(tmp_path / "port"), str(tmp_path / "ref")
    k = splits[0]
    deploy_collection(_part(col, 0, k), CFG, root, **kw)
    j_deploy(_jpart(jcol, 0, k), J_CFG, jroot, **kw)
    if damage is not None:
        damage(root)
        damage(jroot)
    for b in splits[1:]:
        append_instances(_part(col, k, k + b), root)
        j_append(_jpart(jcol, k, k + b), jroot)
        k += b
    return root, jroot


# ---------------------------------------------------------------------------
# append_instances: the reference's files, fast path and fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [(3, 3), (2, 1, 3), (1, 1, 1, 1, 1, 1),
                                    (5, 1)])
@pytest.mark.parametrize("sparse", [True, False], ids=["chain", "plain"])
def test_append_writes_the_references_files(cols, tmp_path, splits, sparse):
    root, jroot = _grow_both(cols, tmp_path, splits, sparse)
    _same_deployment(root, jroot)
    assert read_json_slice(os.path.join(root, "collection.json"))[
        "version"] == len(splits) - 1


def _stale_tile_map(root):
    path = os.path.join(root, tile_map_name("latency"))
    arrs = read_array_slice(path)
    write_array_slice(path, {**arrs, "n_packs": arrs["n_packs"] + 1})


def _torn_delta(root):
    path = os.path.join(root, delta_slice_name("latency") + ".npz")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])


@pytest.mark.parametrize("damage", [_stale_tile_map, _torn_delta],
                         ids=["stale_tile_map", "torn_delta"])
def test_append_fallback_rebuilds_as_the_reference(cols, tmp_path, damage):
    """A chain that no longer validates is rebuilt from the full history:
    the same files as the reference's rebuild, and the same chain as a
    one-shot deploy of the grown collection."""
    root, jroot = _grow_both(cols, tmp_path, (3, 3), damage=damage)
    _same_deployment(root, jroot)
    once = str(tmp_path / "once")
    deploy_collection(cols[0], CFG, once, sparse_absent={"latency": INF})
    for name in (delta_slice_name("latency"), tile_map_name("latency")):
        a = read_array_slice(os.path.join(root, name))
        b = read_array_slice(os.path.join(once, name))
        for k in b:
            _bits(a[k], b[k], f"{name}[{k}]")


def test_append_keeps_payload_ids_and_dedups(cols, tmp_path):
    """Fast path: the recorded payloads and old references are kept
    bitwise and the pool grows by the new unique tiles only (a slowly
    varying collection reuses most of its tiles)."""
    col, _ = cols
    root = str(tmp_path / "g")
    deploy_collection(_part(col, 0, 3), CFG, root,
                      sparse_absent={"latency": INF})
    before = read_array_slice(os.path.join(root, delta_slice_name("latency")))
    append_instances(_part(col, 3, 6), root)
    after = read_array_slice(os.path.join(root, delta_slice_name("latency")))
    for k in ("payloads_local", "payloads_boundary"):
        n = len(before[k])
        _bits(after[k][:n], before[k], k)
        assert n < len(after[k]) < 2 * n
    for k in ("ref_local", "ref_boundary"):
        _bits(after[k][:3], before[k], k)


def test_append_rejects_another_template(cols, tmp_path):
    col, _ = cols
    root = str(tmp_path / "g")
    deploy_collection(_part(col, 0, 2), CFG, root)
    t = col.template
    fewer = dataclasses.replace(t, src=t.src[:-1], dst=t.dst[:-1])
    with pytest.raises(ValueError, match="template does not match"):
        append_instances(TimeSeriesGraph(template=fewer,
                                         instances=col.instances[2:3]),
                         root)


@pytest.mark.parametrize("grower", ["port", "ref"])
def test_grown_deployment_loads_in_both_packages(cols, tmp_path, grower):
    """A deployment grown by either package: both stores read the same
    attribute matrices and the same delta batch (the chain, not the
    fallback), equal to the full sparse fill."""
    from repro.core.blocked import build_blocked as j_build_blocked
    from repro.core.partition import partition_graph as j_partition
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.partition import partition_graph

    col, jcol = cols
    root, jroot = _grow_both(cols, tmp_path, (2, 1, 3))
    r = root if grower == "port" else jroot
    st, jst = GoFSStore(r), JGoFSStore(r)
    assert st.version == jst.version == 2
    for name in ("latency", "active"):
        _bits(st.edge_attr_matrix(name), jst.edge_attr_matrix(name), name)
    bg = build_blocked(col.template, partition_graph(
        col.template, CFG.num_partitions, seed=CFG.seed), CFG.block_size)
    jbg = j_build_blocked(jcol.template, j_partition(
        jcol.template, J_CFG.num_partitions, seed=J_CFG.seed),
        J_CFG.block_size)
    sp = st.load_blocked(bg, "latency", zero=INF, layout="sparse", delta=True)
    jsp = jst.load_blocked(jbg, "latency", zero=INF, layout="sparse",
                           delta=True)
    assert sp.source_bytes is not None
    assert sp.source_bytes == jsp.source_bytes
    ref = bg.stage_sparse(np.stack([col.edge_values(t, "latency")
                                    for t in range(len(col))]), zero=INF)
    for f in ("tiles", "btiles", "rows", "cols", "brows", "bcols", "nnz",
              "bnnz"):
        _bits(getattr(sp, f), np.asarray(getattr(jsp, f)), f)
        _bits(getattr(sp, f), getattr(ref, f), f)


# ---------------------------------------------------------------------------
# tests/test_delta.py's grown_env cases, on the port
# ---------------------------------------------------------------------------

@pytest.fixture()
def grown_env(cols, tmp_path):
    """A prefix deployment grown by one append (manifest version 1)."""
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.partition import partition_graph

    col, _ = cols
    root = str(tmp_path / "gofs")
    deploy_collection(_part(col, 0, 3), CFG, root,
                      sparse_absent={"latency": INF})
    append_instances(_part(col, 3, len(col)), root)
    bg = build_blocked(col.template, partition_graph(
        col.template, CFG.num_partitions, seed=CFG.seed), CFG.block_size)
    return col, root, bg


def _store(root):
    return GoFSStore(root, cache_slots=CFG.cache_slots)


def _full_ref(col, bg):
    w = np.stack([col.edge_values(t, "latency")
                  for t in range(len(col))]).astype(np.float32)
    return bg.stage_sparse(w, zero=INF)


def test_appended_delta_chain_serves(grown_env):
    col, root, bg = grown_env
    store = _store(root)
    assert store.version == 1
    out = store.load_blocked(bg, "latency", zero=INF, layout="sparse",
                             delta=True)
    ref = _full_ref(col, bg)
    _bits(out.tiles, ref.tiles)
    _bits(out.btiles, ref.btiles)
    assert out.source_bytes is not None  # chain used, not the fallback
    ratio, monotone = store.delta_stats("latency", zero=INF)
    assert ratio is not None and 0.0 < ratio < 1.0


@pytest.mark.parametrize("which", ["delta", "tilemap"])
def test_truncated_appended_slice_falls_back(grown_env, which):
    col, root, bg = grown_env
    name = delta_slice_name("latency") if which == "delta" \
        else tile_map_name("latency")
    p = os.path.join(root, name + ".npz")
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[: len(data) // 2])
    store = _store(root)
    if which == "tilemap":
        assert store.tile_occupancy(bg, "latency", zero=INF) is None
        assert store.sparse_buckets(bg, "latency", zero=INF) is None
    out = store.load_blocked(bg, "latency", zero=INF, layout="sparse",
                             delta=True)
    _bits(out.tiles, _full_ref(col, bg).tiles)
    if which == "delta":
        assert out.source_bytes is None


def test_appended_pool_fingerprint_mismatch_falls_back(grown_env):
    col, root, bg = grown_env
    path = os.path.join(root, delta_slice_name("latency"))
    arrs = read_array_slice(path)
    bad = arrs["tiles_rc"].copy()
    bad[0] ^= 1
    write_array_slice(path, {**arrs, "tiles_rc": bad})
    out = _store(root).load_blocked(bg, "latency", zero=INF,
                                    layout="sparse", delta=True)
    _bits(out.tiles, _full_ref(col, bg).tiles)
    assert out.source_bytes is None


def test_manifest_delta_version_skew_falls_back(grown_env):
    col, root, bg = grown_env
    path = os.path.join(root, delta_slice_name("latency"))
    arrs = read_array_slice(path)
    write_array_slice(path, {
        **arrs, "n_instances": np.asarray(3),
        "ref_local": arrs["ref_local"][:3],
        "ref_boundary": arrs["ref_boundary"][:3]})
    store = _store(root)
    assert store.num_timesteps() == len(col)
    out = store.load_blocked(bg, "latency", zero=INF, layout="sparse",
                             delta=True)
    _bits(out.tiles, _full_ref(col, bg).tiles)
    assert out.source_bytes is None


def test_corrupt_manifest_refresh_keeps_serving(grown_env):
    col, root, bg = grown_env
    store = _store(root)
    before = store.load_blocked(bg, "latency", zero=INF, layout="sparse",
                                delta=True)
    man = os.path.join(root, "collection.json")
    with open(man) as f:
        text = f.read()
    with open(man, "w") as f:
        f.write(text[: len(text) // 2])
    assert store.refresh() is False
    after = store.load_blocked(bg, "latency", zero=INF, layout="sparse",
                               delta=True)
    _bits(before.tiles, after.tiles)
    with open(man, "w") as f:
        f.write(text)
    assert store.refresh() is False


def test_refresh_invalidates_as_the_reference(cols, tmp_path):
    """After an append each store drops the same cache keys (the tail
    pack's value slices, tile maps, the delta pool) and keeps the rest."""
    col, _ = cols
    root = str(tmp_path / "g")
    deploy_collection(_part(col, 0, 3), CFG, root,
                      sparse_absent={"latency": INF})
    st, jst = GoFSStore(root, cache_slots=64), JGoFSStore(root,
                                                          cache_slots=64)
    for s in (st, jst):
        s.edge_attr_matrix("latency")
        s.edge_tile_maps("latency")
        s.edge_delta_index("latency")
    keys = sorted(st.cache._data)
    assert keys == sorted(jst.cache._data)
    append_instances(_part(col, 3, 5), root)
    assert st.refresh() is True and jst.refresh() is True
    assert sorted(st.cache._data) == sorted(jst.cache._data)
    assert len(st.cache._data) < len(keys)
    assert (st.version, st.num_timesteps()) == (jst.version,
                                               jst.num_timesteps())
    _bits(st.edge_attr_matrix("latency"), jst.edge_attr_matrix("latency"))


# ---------------------------------------------------------------------------
# the streaming property: append + tail is invisible
# ---------------------------------------------------------------------------

def _same_update(u, ju, what):
    assert (u.mode, u.new_instances, u.version) == \
        (ju.mode, ju.new_instances, ju.version), what
    assert set(u.result.output) == set(ju.result.output), what
    for k, v in ju.result.output.items():
        _bits(u.result.output[k], np.asarray(v), f"{what} output[{k}]")
    for k, v in ju.result.engine.stats.items():
        _bits(u.result.engine.stats[k], np.asarray(v), f"{what} {k}")
    _bits(u.result.engine.values, np.asarray(ju.result.engine.values), what)


def _assert_streaming_parity(seed: int, tmp_path) -> None:
    """tests/test_parity_properties.py's streaming case, grown by the
    port's ``append_instances`` and tailed by both packages' sessions on
    the same store."""
    cfg, jcol, rng = _streaming_case(seed)
    col = TimeSeriesGraph(template=jcol.template, instances=jcol.instances)
    n_total = len(col)
    k = int(rng.integers(1, n_total))
    knobs = dict(
        source=int(rng.integers(0, cfg.num_vertices)),
        pattern=str(rng.choice(["sequential", "independent"])),
        layout=str(rng.choice(["dense", "sparse"])),
        staging=str(rng.choice(["sync", "async"])),
        warm=bool(rng.integers(0, 2)),
    )
    root = str(tmp_path / f"stream_{seed}")
    deploy_collection(_part(col, 0, k), cfg, root,
                      sparse_absent={"latency": INF})
    sess = GopherSession(GoFSStore(root, cache_slots=cfg.cache_slots),
                         block_size=cfg.block_size, device="cpu")
    jsess = JGopherSession(JGoFSStore(root, cache_slots=cfg.cache_slots),
                           block_size=cfg.block_size)
    u, ju = sess.tail("sssp", **knobs), jsess.tail("sssp", **knobs)
    assert u.mode == "full" and u.new_instances == k
    _same_update(u, ju, f"first tail ({knobs})")
    pos = k
    while pos < n_total:
        b = int(rng.integers(1, n_total - pos + 1))
        append_instances(_part(col, pos, pos + b), root)
        pos += b
        u, ju = sess.tail("sssp", **knobs), jsess.tail("sssp", **knobs)
        assert u.mode == "incremental" and u.new_instances == b, knobs
        _same_update(u, ju, f"tail at {pos} ({knobs})")
    u2, ju2 = sess.tail("sssp", **knobs), jsess.tail("sssp", **knobs)
    assert u2.mode == "noop" and u2.result is u.result
    _same_update(u2, ju2, "noop")
    cold = GopherSession(GoFSStore(root, cache_slots=cfg.cache_slots),
                         block_size=cfg.block_size, device="cpu")
    ref = cold.run(cold.plan("sssp", **knobs))
    for key, v in ref.output.items():
        _bits(u.result.output[key], v, f"tail vs cold {key} ({knobs})")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_parity_fixed_seeds(seed, tmp_path):
    _assert_streaming_parity(seed, tmp_path)


@settings(max_examples=5, deadline=None)
@given(seed=hyp_st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_streaming_parity_property(seed, tmp_path_factory):
    _assert_streaming_parity(seed, tmp_path_factory.mktemp("prop"))


def _grown_sessions(cols, tmp_path, **kw):
    col, _ = cols
    root = str(tmp_path / "live")
    deploy_collection(_part(col, 0, 3), CFG, root,
                      sparse_absent={"latency": INF})
    return (col, root,
            GopherSession(GoFSStore(root), block_size=CFG.block_size,
                          device="cpu", **kw),
            JGopherSession(JGoFSStore(root), block_size=CFG.block_size, **kw))


@pytest.mark.parametrize("analytic,params", [
    ("pagerank", {"iters": 5}),
    ("nhop", {"source": 3, "n_hops": 3}),
    ("sssp", {"source": [0, 7, 19], "pattern": "independent",
              "warm": True}),
])
def test_tail_other_analytics_match_reference(cols, tmp_path, analytic,
                                              params):
    """Row-wise PageRank (incremental, rtol 1e-5), N-hop (composite: a
    full re-run) and multi-source warm SSSP (incremental, seeded by a
    (Q, P, Vp) ``resume_seed``) over two appends."""
    col, root, sess, jsess = _grown_sessions(cols, tmp_path)
    for lo, hi in ((None, None), (3, 4), (4, 6)):
        if lo is not None:
            append_instances(_part(col, lo, hi), root)
        u, ju = sess.tail(analytic, **params), jsess.tail(analytic, **params)
        assert (u.mode, u.new_instances, u.version) == \
            (ju.mode, ju.new_instances, ju.version)
        if analytic == "pagerank":
            np.testing.assert_allclose(u.result.output["ranks"],
                                       np.asarray(ju.result.output["ranks"]),
                                       rtol=PR_RTOL, atol=PR_ATOL)
            continue
        for k, v in ju.result.output.items():
            _bits(u.result.output[k], np.asarray(v), k)
    assert u.mode == ("full" if analytic == "nhop" else "incremental")


# ---------------------------------------------------------------------------
# resume_seed and session refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [None, 3])
def test_resume_seed_matches_reference(cols, q):
    from repro.core.blocked import build_blocked as j_build_blocked
    from repro.core.partition import partition_graph as j_partition
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.partition import partition_graph

    col, jcol = cols
    bg = build_blocked(col.template, partition_graph(
        col.template, CFG.num_partitions, seed=CFG.seed), CFG.block_size)
    jbg = j_build_blocked(jcol.template, j_partition(
        jcol.template, J_CFG.num_partitions, seed=J_CFG.seed),
        J_CFG.block_size)
    V = col.template.num_vertices
    rng = np.random.default_rng(5)
    fin = rng.uniform(0, 9, (V,) if q is None else (q, V)).astype(np.float32)
    fin[..., 0] = -0.0
    fin[..., 1] = INF
    for pad in (INF, 0.0):
        got = TemporalEngine(bg, device="cpu").resume_seed(fin, pad=pad)
        want = JTemporalEngine(jbg).resume_seed(fin, pad=pad)
        _bits(got, np.asarray(want), f"pad {pad}")
        assert got.shape == ((bg.n_parts, bg.vp) if q is None
                             else (q, bg.n_parts, bg.vp))


def test_session_refresh_matches_reference(cols, tmp_path):
    """A warm session (session-lifetime staging cache) over a growing
    store: after an append both packages keep and drop the same cache
    keys, report the same staging-cache counters, extend the dense raw
    batch to the reference's bitwise, and answer as a cold session."""
    col, root, sess, jsess = _grown_sessions(
        cols, tmp_path, staging_cache_bytes=1 << 30)
    plans = [("sssp", dict(source=0, layout="dense")),
             ("sssp", dict(source=0, layout="sparse")),
             ("pagerank", dict(iters=5)),
             ("tracking", dict(plate=1, initial_vertex=0))]

    def run_all():
        sess.run_many([sess.plan(n, **k) for n, k in plans])
        jsess.run_many([jsess.plan(n, **k) for n, k in plans])

    run_all()
    assert sess.refresh() is False and jsess.refresh() is False
    assert sorted(sess._w_cache) == sorted(jsess._w_cache)
    append_instances(_part(col, 3, 5), root)
    assert sess.refresh() is True and jsess.refresh() is True
    assert sess.num_instances == jsess.num_instances == 5
    assert sorted(sess._w_cache) == sorted(jsess._w_cache)
    assert ("raw", "latency") in sess._w_cache
    assert list(sess._staging_cache.entries) == \
        list(jsess._staging_cache.entries)
    assert sess.staging_cache_stats() == jsess.staging_cache_stats()
    key = ("template", "latency", "raw", INF, "dense")
    b, jb = sess._staging_cache.entries[key], \
        jsess._staging_cache.entries[key]
    _bits(b.tiles, np.asarray(jb.tiles))
    _bits(b.btiles, np.asarray(jb.btiles))
    assert b.tiles.shape[0] == 5
    run_all()
    assert sess.staging_cache_stats() == jsess.staging_cache_stats()
    assert sess.last_run_report == jsess.last_run_report
    got = sess.run(sess.plan("sssp", source=0, layout="dense"))
    cold = GopherSession(GoFSStore(root), block_size=CFG.block_size,
                         device="cpu")
    _bits(got.engine.values,
          cold.run(cold.plan("sssp", source=0)).engine.values)


def test_refresh_of_in_memory_sources_is_false(cols):
    col, _ = cols
    sess = GopherSession(col, num_partitions=3, block_size=32, device="cpu")
    assert sess.refresh() is False
    u = sess.tail("sssp", source=0)
    assert u.mode == "full" and u.version is None
    assert sess.tail("sssp", source=0).mode == "noop"
