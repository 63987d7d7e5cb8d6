"""The port's Gopher session (registry, planner, run/run_many) against the
JAX package's (``tests/test_gopher.py``'s cases, on the port).

* Registry: the same analytics with the same staging contracts and
  parameters.
* Plans: a reference ``GopherSession`` and the port's on the same
  collection (a GoFS deployment opened by both, ``from_blocked``, and a
  ``TimeSeriesGraph``) give plans equal field by field except ``kernel``,
  whose value is ``off`` in both on the CPU; ``explain()`` is equal line
  by line except the kernel line.
* ``run`` and ``run_many``: min-plus results bitwise (values, final,
  supersteps, local sweeps, histograms, labels) across patterns, dense
  and sparse layouts, sync and async staging, delta on and off; PageRank
  within rtol 1e-5 / atol 1e-7; ``merged`` within rtol 1e-6.  The
  staging report (bytes, passes, hits) equals the reference's.
* The deprecated ``run_blocked`` wrappers warn and equal the session.
* The quickstart's steps 4 and 6, on the port.
* What is not ported raises naming its ROADMAP item.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition_graph
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
from repro.gopher import GopherSession as JGopherSession
from repro.gopher import get_analytic as j_get_analytic
import repro_torch.core.engine as T
from repro_torch.configs.base import GraphConfig
from repro_torch.core.algorithms import components, nhop, pagerank, sssp
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.gofs import GoFSStore, deploy_collection
from repro_torch.gopher import (
    GopherSession, REQUIRED, get_analytic, list_analytics,
    register_analytic)
from repro_torch.gopher.registry import _REGISTRY

from tests.conftest import TINY as J_TINY

TINY = GraphConfig(**dataclasses.asdict(J_TINY))
INF = float(np.inf)
# PageRank: the reference's tolerances on itself (ROADMAP ground rules)
PR_RTOL, PR_ATOL = 1e-5, 1e-7
MERGED_RTOL = 1e-6
CHOICES = ("layout", "comm", "staging", "delta", "warm", "placement")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tiny_collection, tmp_path_factory):
    """TINY in both packages: the collections, blocked structures, weight
    matrices, and one deployment (latency tile maps and delta chain)
    that both packages' stores open."""
    col = generate_collection(TINY, num_plates=6)
    jcol = tiny_collection
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(
        tmpl, TINY.num_partitions, seed=TINY.seed), TINY.block_size)
    jbg = j_build_blocked(jcol.template, j_partition_graph(
        jcol.template, J_TINY.num_partitions, seed=J_TINY.seed),
        J_TINY.block_size)
    I = len(col)
    w = np.stack([col.edge_values(t, "latency") for t in range(I)])
    act = np.stack([col.edge_values(t, "active") for t in range(I)])
    root = str(tmp_path_factory.mktemp("gopher_gofs"))
    deploy_collection(col, TINY, root, sparse_absent={"latency": INF})
    return dict(col=col, jcol=jcol, bg=bg, jbg=jbg, w=w, act=act,
                root=root, src=tmpl.src, dst=tmpl.dst)


def _sessions(env, kind, **kw):
    """(port session on the CPU, reference session) over one source."""
    if kind == "store":
        return (GopherSession(GoFSStore(env["root"]), device="cpu", **kw),
                JGopherSession(JGoFSStore(env["root"]), **kw))
    if kind == "tsg":
        return (GopherSession(env["col"], num_partitions=3, block_size=32,
                              device="cpu", **kw),
                JGopherSession(env["jcol"], num_partitions=3, block_size=32,
                               **kw))
    wts = {"latency": env["w"], "active": env["act"]}
    return (GopherSession.from_blocked(env["bg"], weights=wts,
                                       src=env["src"], dst=env["dst"],
                                       device="cpu", **kw),
            JGopherSession.from_blocked(env["jbg"], weights=wts,
                                        src=env["src"], dst=env["dst"],
                                        **kw))


def _choice(c):
    return (c.value, c.source, c.reason)


def _same_plan(p, j):
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if f.name == "kernel":
            assert a.value == b.value == "off", (a, b)
        elif f.name in CHOICES:
            assert _choice(a) == _choice(b), f.name
        else:
            assert a == b, f.name
    lp, lj = p.explain().splitlines(), j.explain().splitlines()
    assert len(lp) == len(lj)
    for a, b in zip(lp, lj):
        if a.lstrip().startswith("kernel"):
            assert b.lstrip().startswith("kernel")
        else:
            assert a == b


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def _same_engine(got, want):
    for f in ("values", "final"):
        _eq(getattr(got, f), getattr(want, f), f)
    for k in ("supersteps", "local_sweeps"):
        _eq(got.stats[k], want.stats[k], k)
    if want.merged is not None:
        np.testing.assert_allclose(got.merged, np.asarray(want.merged),
                                   rtol=MERGED_RTOL)
    assert got.occupancy == want.occupancy
    assert got.warm_start == want.warm_start


def _same_result(got, want):
    """AnalyticResult: engine results and outputs, bitwise except
    PageRank's ranks (rtol 1e-5 / atol 1e-7)."""
    assert set(got.output) == set(want.output)
    for k, v in got.output.items():
        if k == "ranks":
            np.testing.assert_allclose(v, np.asarray(want.output[k]),
                                       rtol=PR_RTOL, atol=PR_ATOL)
        else:
            _eq(v, want.output[k], k)
    if got.plan.analytic == "pagerank":
        np.testing.assert_allclose(got.engine.values, want.engine.values,
                                   rtol=PR_RTOL, atol=PR_ATOL)
    elif want.engine is not None:
        _same_engine(got.engine, want.engine)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_stock_analytics_registered():
    assert list_analytics() == ["components", "nhop", "pagerank", "sssp",
                                "tracking"]


@pytest.mark.parametrize("name", ["components", "nhop", "pagerank", "sssp",
                                  "tracking"])
def test_registry_entry_matches_reference(name):
    a, j = get_analytic(name), j_get_analytic(name)
    for f in ("name", "pattern", "attr", "zero_fill", "graph", "merge",
              "rowwise", "source_axis", "composite", "transform_name",
              "describe"):
        assert getattr(a, f) == getattr(j, f), f
    assert list(a.params) == list(j.params)
    for k, v in a.params.items():
        if isinstance(v, np.ndarray):
            _eq(v, j.params[k], k)
        else:
            assert repr(v) == repr(j.params[k]), k


def test_duplicate_registration_rejected():
    try:
        @register_analytic("_dup_probe", pattern="sequential",
                           attr="latency", zero_fill=INF)
        def _p1(ctx):
            raise NotImplementedError

        with pytest.raises(ValueError, match="already registered"):
            @register_analytic("_dup_probe", pattern="sequential",
                               attr="latency", zero_fill=INF)
            def _p2(ctx):
                raise NotImplementedError
    finally:
        _REGISTRY.pop("_dup_probe", None)


def test_unknown_analytic_and_params(env):
    with pytest.raises(KeyError, match="sssp"):
        get_analytic("ssssp")
    sess, _ = _sessions(env, "blocked")
    with pytest.raises(TypeError, match="unknown parameter"):
        sess.plan("sssp", source=0, sources=1)
    with pytest.raises(TypeError, match="required parameter"):
        sess.plan("sssp")


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------

PLAN_CASES = {
    "sssp": ("sssp", dict(source=0)),
    "sssp_sparse": ("sssp", dict(source=0, layout="sparse")),
    "sssp_overrides": ("sssp", dict(source=0, pattern="eventually",
                                    merge="mean", comm="host", delta=True,
                                    warm=True, staging="sync")),
    "sssp_sources": ("sssp", dict(source=[0, 5])),
    "pagerank": ("pagerank", dict(iters=5)),
    "components": ("components", {}),
    "nhop": ("nhop", dict(source=0, n_hops=3)),
}


@pytest.mark.parametrize("kind", ["store", "blocked", "tsg"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_reference(env, kind, case):
    name, kw = PLAN_CASES[case]
    sess, jsess = _sessions(env, kind)
    _same_plan(sess.plan(name, **kw), jsess.plan(name, **kw))


def test_plan_deterministic_and_reads_no_value_slice(env):
    p1 = GopherSession(GoFSStore(env["root"]), device="cpu").plan(
        "sssp", source=0)
    store = GoFSStore(env["root"])
    sess = GopherSession(store, device="cpu")
    store.reset_stats()
    p2 = sess.plan("sssp", source=0)
    sess.plan("nhop", source=0)
    assert store.stats.slices_read <= 1  # the tile map only
    assert p1 == p2 and p1.explain() == p2.explain()


def test_kernel_rule_by_device(env):
    """The kernel knob keys on the session's device: off on the CPU; on
    CUDA fused at recorded occupancy <= 25%, else spmv (the planner's
    rule, driven directly)."""
    from repro_torch.gopher.planner import plan_analytic

    sess, _ = _sessions(env, "blocked")
    a = get_analytic("sssp")
    kw = dict(bg=env["bg"], store_backed=False, sparse_buckets=None,
              num_instances=3)
    pick = {(dev, occ): plan_analytic(a, {"source": 0}, occupancy=occ,
                                      device=dev, **kw).kernel.value
            for dev in ("cpu", "cuda") for occ in (0.1, 0.9, None)}
    assert pick == {("cpu", 0.1): "off", ("cpu", 0.9): "off",
                    ("cpu", None): "off", ("cuda", 0.1): "fused",
                    ("cuda", 0.9): "spmv", ("cuda", None): "spmv"}
    assert sess.plan("sssp", source=0, kernel="fused").kernel.source \
        == "override"
    sess_f = GopherSession.from_blocked(
        env["bg"], weights={"latency": env["w"]}, device="cpu",
        use_pallas="fused")
    assert sess_f.plan("sssp", source=0).kernel.value == "fused"


# --------------------------------------------------------------------------
# run and run_many against the reference
# --------------------------------------------------------------------------

RUN_CASES = {
    "sssp_sequential_dense": ("sssp", dict(source=0)),
    "sssp_independent_sparse": ("sssp", dict(source=3, pattern="independent",
                                              layout="sparse")),
    "sssp_eventually_mean": ("sssp", dict(source=0, pattern="eventually",
                                          merge="mean")),
    "sssp_host_comm_sparse": ("sssp", dict(source=0, comm="host",
                                           layout="sparse")),
    "components": ("components", {}),
    "pagerank": ("pagerank", dict(iters=6)),
    "nhop": ("nhop", dict(source=0, n_hops=3)),
}


@pytest.mark.parametrize("kind", ["store", "blocked"])
@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_matches_reference(env, kind, case):
    name, kw = RUN_CASES[case]
    sess, jsess = _sessions(env, kind)
    plan, jplan = sess.plan(name, **kw), jsess.plan(name, **kw)
    _same_plan(plan, jplan)
    _same_result(sess.run(plan), jsess.run(jplan))
    assert sess.last_run_report == jsess.last_run_report


STORE_CASES = {
    "dense_sync": dict(layout="dense", staging="sync"),
    "dense_async": dict(layout="dense", staging="async"),
    "sparse_sync_delta": dict(layout="sparse", staging="sync", delta=True),
    "sparse_async_delta": dict(layout="sparse", staging="async", delta=True),
    "sparse_sync_full": dict(layout="sparse", staging="sync", delta=False),
    "sparse_async_full": dict(layout="sparse", staging="async",
                              delta=False),
    "warm_async": dict(layout="sparse", staging="async", warm=True,
                       pattern="independent"),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_staging_routes_bitwise(env, case):
    """Every staging route of a store-backed SSSP equals the reference's
    same route bitwise, reports the same staged bytes and passes, and
    (cold routes) equals the port's dense sync run.  TINY's latencies are
    drawn anew per instance, so a warm seed is not exact there: the warm
    route is held to the reference's warm route only."""
    kw = STORE_CASES[case]
    sess, jsess = _sessions(env, "store")
    got = sess.run(sess.plan("sssp", source=0, **kw))
    want = jsess.run(jsess.plan("sssp", source=0, **kw))
    _same_result(got, want)
    assert sess.last_run_report == jsess.last_run_report
    if kw.get("warm"):
        return
    base = GopherSession(GoFSStore(env["root"]), device="cpu")
    pat = kw.get("pattern", "sequential")
    ref = base.run(base.plan("sssp", source=0, pattern=pat,
                             layout="dense", staging="sync"))
    _eq(got.engine.values, ref.engine.values)


def test_run_many_shares_staging_bitwise(env):
    """sssp + sssp + nhop share the latency batch (nhop's hop probe stages
    the unit-weight batch): two staging passes, as in the reference, and
    each result equals its solo run and the reference's."""
    sess, jsess = _sessions(env, "blocked")
    kws = [("sssp", dict(source=0)),
           ("sssp", dict(source=1, pattern="independent")),
           ("nhop", dict(source=0, n_hops=3))]
    rs = sess.run_many([sess.plan(n, **k) for n, k in kws])
    js = jsess.run_many([jsess.plan(n, **k) for n, k in kws])
    assert sess.last_run_report == jsess.last_run_report
    assert sess.last_run_report["staging_passes"] == 2
    for (n, k), got, want in zip(kws, rs, js):
        _same_result(got, want)
        solo, _ = _sessions(env, "blocked")
        _same_result(got, solo.run(solo.plan(n, **k)))


def test_run_many_streamed_group(env):
    """N async program plans over one attribute: ONE prefetch pass feeds
    N engine runs; results equal the per-plan runs and the reference."""
    sess, jsess = _sessions(env, "store")
    plans = [sess.plan("sssp", source=0), sess.plan("sssp", source=1),
             sess.plan("sssp", source=2, pattern="eventually",
                       merge="mean")]
    assert all(p.staging.value == "async" for p in plans)
    rs = sess.run_many(plans)
    assert sess.last_run_report["staging_passes"] == 1
    js = jsess.run_many([jsess.plan(p.analytic, pattern=p.pattern,
                                    merge=p.merge, **p.param_dict)
                         for p in plans])
    assert sess.last_run_report == jsess.last_run_report
    for p, got, want in zip(plans, rs, js):
        _same_result(got, want)
        solo, _ = _sessions(env, "store")
        _same_result(got, solo.run(p))


def test_run_many_mixed_comm_shares_staging(env):
    sess, jsess = _sessions(env, "store")
    plans = [("sssp", dict(source=0)), ("sssp", dict(source=1,
                                                     comm="host"))]
    rs = sess.run_many([sess.plan(n, **k) for n, k in plans])
    js = jsess.run_many([jsess.plan(n, **k) for n, k in plans])
    assert sess.last_run_report["staging_passes"] == 1
    assert sess.last_run_report == jsess.last_run_report
    for got, want in zip(rs, js):
        _same_result(got, want)


def test_session_lifetime_cache_and_keys(env, monkeypatch):
    """With ``staging_cache_bytes`` the session keeps staged batches: a
    repeat re-stages and re-uploads nothing (counted at the engine's
    ``_device_put``), and batches of one attribute under another
    transform or semiring zero never alias."""
    def _halved(ctx, w):
        return np.asarray(w, np.float32) * np.float32(0.5)

    def _probe(name, weights=None, zero=INF):
        @register_analytic(name, pattern="sequential", attr="latency",
                           zero_fill=zero, params={"source": REQUIRED},
                           weights=weights)
        def _prog(ctx, *, source):
            return T.min_plus_program(name, init=T.source_init(source))

    names = ("_key_raw", "_key_halved", "_key_zero0")
    try:
        _probe("_key_raw")
        _probe("_key_halved", weights=_halved)
        _probe("_key_zero0", zero=0.0)
        sess = GopherSession.from_blocked(
            env["bg"], weights={"latency": env["w"]}, device="cpu",
            staging_cache_bytes=1 << 30)
        plans = [sess.plan(n, source=0, layout="dense") for n in names]
        rs = sess.run_many(plans)
        assert sess.last_run_report["staging_passes"] == 3
        assert sess.staging_cache_stats()["entries"] == 3
        raw, halved, z0 = (r.engine.values for r in rs)
        finite = np.isfinite(raw)
        assert np.array_equal(halved[finite], raw[finite] * np.float32(0.5))
        assert not np.array_equal(z0, raw)
        calls = []
        orig = T._device_put
        monkeypatch.setattr(T, "_device_put",
                            lambda x, d: calls.append(1) or orig(x, d))
        rs2 = sess.run_many(plans)
        assert calls == [], "warm repeat re-uploaded staged tiles"
        assert sess.last_run_report["staging_passes"] == 0
        assert sess.last_run_report["cache_hits"] == 3
        for a, b in zip(rs, rs2):
            assert np.array_equal(a.engine.values, b.engine.values)
    finally:
        for n in names:
            _REGISTRY.pop(n, None)


def test_streamed_session_binds_the_prefetcher(env, monkeypatch):
    """A streamed group reaches the prefetcher under the session's byte
    counting: the engine binds its pool-thread hook (and, on CUDA, the
    pinned ring; none on the CPU) for the pass and unbinds it after."""
    from repro_torch.gofs.prefetch import SlicePrefetcher

    calls = []
    orig = SlicePrefetcher.bind

    def spy(self, *args, **kw):
        calls.append(args)
        return orig(self, *args, **kw)

    monkeypatch.setattr(SlicePrefetcher, "bind", spy)
    sess, jsess = _sessions(env, "store")
    got = sess.run(sess.plan("sssp", source=0, layout="sparse"))
    _same_result(got, jsess.run(jsess.plan("sssp", source=0,
                                           layout="sparse")))
    assert len(calls) == 2
    assert calls[0][0] is None and callable(calls[0][1])
    assert calls[1] == ()


# --------------------------------------------------------------------------
# deprecated wrappers
# --------------------------------------------------------------------------

def test_run_blocked_wrappers_deprecated_and_identical(env):
    from repro.core.algorithms import components as j_components
    from repro.core.algorithms import nhop as j_nhop
    from repro.core.algorithms import pagerank as j_pagerank
    from repro.core.algorithms import sssp as j_sssp

    bg, jbg, w, act = env["bg"], env["jbg"], env["w"], env["act"]
    src, dst, V = env["src"], env["dst"], len(env["bg"].part_of)
    with pytest.warns(DeprecationWarning, match="sssp.run_blocked"):
        d, stats = sssp.run_blocked(bg, w, 0, device="cpu")
    with pytest.warns(DeprecationWarning):
        jd, jstats = j_sssp.run_blocked(jbg, w, 0)
    _eq(d, jd)
    _eq(stats["supersteps"], jstats["supersteps"])
    sess = GopherSession.from_blocked(bg, weights={"latency": w},
                                      device="cpu")
    _eq(d, sess.run(sess.plan("sssp", source=0)).output["final"])

    with pytest.warns(DeprecationWarning, match="pagerank.run_blocked"):
        ranks, ss = pagerank.run_blocked(bg, src, act, num_vertices=V,
                                         iters=5, device="cpu")
    with pytest.warns(DeprecationWarning):
        jranks, _ = j_pagerank.run_blocked(jbg, src, act, num_vertices=V,
                                           iters=5)
    np.testing.assert_allclose(ranks, np.asarray(jranks), rtol=PR_RTOL,
                               atol=PR_ATOL)
    assert list(ss) == [5] * len(w)

    with pytest.warns(DeprecationWarning, match="components"):
        labels = components.run_blocked(bg, src, dst, act[0], device="cpu")
    _eq(labels, components.oracle(src, dst, act[0], V))
    with pytest.warns(DeprecationWarning, match="components"):
        lt = components.run_blocked_temporal(bg, src, dst, act,
                                             device="cpu")
    with pytest.warns(DeprecationWarning):
        _eq(lt, j_components.run_blocked_temporal(jbg, src, dst, act))

    with pytest.warns(DeprecationWarning, match="nhop.run_blocked"):
        comp, hists = nhop.run_blocked(bg, w, 0, n_hops=3, device="cpu")
    with pytest.warns(DeprecationWarning):
        jcomp, jhists = j_nhop.run_blocked(jbg, w, 0, n_hops=3)
    _eq(comp, jcomp)
    _eq(hists, jhists)
    assert comp.sum() == hists.sum()
    for i in range(len(w)):
        _eq(hists[i], nhop.oracle(src, dst, w[i], V, 0, n_hops=3))


# --------------------------------------------------------------------------
# the quickstart's steps 4 and 6
# --------------------------------------------------------------------------

QUICKSTART = dict(
    name="quickstart", num_vertices=2_000, avg_degree=3.0, num_instances=6,
    num_partitions=4, block_size=64, instances_per_slice=3,
    bins_per_partition=4, cache_slots=14, seed=1,
)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    from repro.configs.base import GraphConfig as JGraphConfig

    cfg = GraphConfig(**QUICKSTART)
    tsg = generate_collection(cfg)
    root = str(tmp_path_factory.mktemp("quickstart_gopher"))
    deploy_collection(tsg, cfg, root, sparse_absent={"latency": INF})
    jcfg = JGraphConfig(**QUICKSTART)
    jtsg = j_generate(jcfg)
    jroot = str(tmp_path_factory.mktemp("quickstart_gopher_ref"))
    j_deploy(jtsg, jcfg, jroot, sparse_absent={"latency": INF})
    kw = dict(cache_slots=14, vertex_projection=(),
              edge_projection=("latency", "active"))
    store = GoFSStore(root, **kw)
    dists, _ = sssp.run_host(store, source_vertex=0)
    d_host = np.full(tsg.template.num_vertices, INF)
    for g, d in dists.items():
        d_host[store.get_topology(g).vertices] = d
    return dict(cfg=cfg, tsg=tsg, store=store, d_host=d_host,
                jstore=JGoFSStore(jroot, **kw))


@pytest.mark.parametrize("layout", [None, "sparse"])
def test_quickstart_steps_4_and_6(quickstart, layout):
    """Step 4: plan -> explain -> run from the store, equal to the host
    run of step 3 and to the explicit engine of step 5.  Step 6: sssp,
    nhop and pagerank in one ``run_many``, each equal to the reference's
    and the sssp to the solo run, with the reference's staging report."""
    q = quickstart
    sess = GopherSession(q["store"], device="cpu")
    jsess = JGopherSession(q["jstore"])
    plan = sess.plan("sssp", source=0, layout=layout)
    jplan = jsess.plan("sssp", source=0, layout=layout)
    _same_plan(plan, jplan)
    r_sssp = sess.run(plan)
    _same_result(r_sssp, jsess.run(jplan))
    d_blk, d_host = r_sssp.output["final"], q["d_host"]
    finite = np.isfinite(d_host)
    _eq(np.isfinite(d_blk), finite)
    np.testing.assert_allclose(d_blk[finite], d_host[finite], rtol=1e-6)
    tmpl, cfg = q["tsg"].template, q["cfg"]
    bg = build_blocked(tmpl, partition_graph(tmpl, cfg.num_partitions,
                                             seed=cfg.seed), cfg.block_size)
    eng = T.TemporalEngine(bg, device="cpu", comm=plan.comm.value,
                           layout=plan.layout.value)
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    if plan.layout.value == "sparse":
        seq = eng.run(prog, pattern="sequential",
                      sparse=q["store"].load_blocked(bg, "latency",
                                                     layout="sparse"))
    else:
        tiles, btiles = q["store"].load_blocked(bg, "latency")
        seq = eng.run(prog, tiles=tiles, btiles=btiles,
                      pattern="sequential")
    _eq(seq.values, r_sssp.engine.values)

    kws = [("sssp", dict(source=0, layout=layout)),
           ("nhop", dict(source=0, n_hops=4, layout=layout)),
           ("pagerank", dict(iters=10))]
    many = sess.run_many([sess.plan(n, **k) for n, k in kws])
    jmany = jsess.run_many([jsess.plan(n, **k) for n, k in kws])
    assert sess.last_run_report == jsess.last_run_report
    for got, want in zip(many, jmany):
        _same_result(got, want)
    _eq(many[0].engine.values, r_sssp.engine.values)


# --------------------------------------------------------------------------
# what is not ported
# --------------------------------------------------------------------------

def test_not_ported_paths_raise(env):
    sess, _ = _sessions(env, "store")
    # streaming ingestion is ported: nothing appended, nothing refreshed
    # (tests/test_torch_stream.py holds refresh and tail against the
    # reference)
    assert sess.refresh() is False
    assert sess.tail("sssp", source=0).mode == "full"
    # resumable runs are ported (tests/test_torch_cluster_checkpoint.py
    # holds them against the reference); a resume needs a directory
    with pytest.raises(AssertionError, match="checkpoint_dir"):
        sess.run(sess.plan("sssp", source=0), resume=True)
    # the query axis is ported: a sequence of sources runs
    # (tests/test_torch_query.py holds it against the reference)
    assert sess.run(sess.plan("sssp", source=[0, 1])).output[
        "final"].shape[0] == 2
    assert sess.run(sess.plan("nhop", source=[0, 1])).output[
        "histograms"].shape[0] == 2
    # mesh placement is ported (tests/test_torch_mesh.py holds it against
    # the reference); a mesh must be a DeviceMesh with named dims
    with pytest.raises(TypeError, match="DeviceMesh"):
        GopherSession(GoFSStore(env["root"]), device="cpu", mesh=object())
    # cluster sessions are ported (tests/test_torch_cluster.py): a
    # single-process runtime leaves the session as it was
    from repro_torch.cluster.runtime import ClusterRuntime

    solo = GopherSession(GoFSStore(env["root"]), device="cpu",
                         cluster=ClusterRuntime(0, 1))
    assert solo.cluster is None


def test_default_device_is_cuda(env):
    """No device= means the card: without CUDA that raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the error path is for hosts "
                    "without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GopherSession.from_blocked(env["bg"], weights={"latency": env["w"]})
