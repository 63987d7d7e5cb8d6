"""The port's GopherService against the JAX package's
(``tests/test_service.py``'s cases, on the port), and its CLIs.

* The twelve service cases: batching invisibility (every result bitwise
  equal to the reference session's run of the same query), source-axis
  merging only when the other parameters agree, the warm cache (repeat
  queries re-stage nothing, ``prestage``), one admission per
  ``submit_many``, concurrent submitters, draining on ``stop``, bad
  requests raising on the caller's thread, engine failures delivered
  through ``wait()`` with the loop serving on.
* ``report()``'s counts equal to the reference service's for the same
  admissions.
* A tailing subscription over two appends, update by update against the
  reference service's subscription on the same store.
* ``tests/test_streaming_stress.py`` on the port (marked ``slow`` as
  there): an appender racing query threads and a subscriber.
* A run of each CLI's ``main`` (``run_graph``, ``serve_graph``,
  ``tail_graph``) at ``--size tiny --device cpu``; without ``--device``
  they ask for the card.

Every wait takes a timeout.
"""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.graph import GraphTemplate as JGraphTemplate
from repro.gofs import GoFSStore as JGoFSStore
from repro.gopher import GopherService as JGopherService
from repro.gopher import GopherSession as JGopherSession
from repro_torch.configs.base import GraphConfig
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.graph import GraphTemplate, TimeSeriesGraph
from repro_torch.gofs import GoFSStore, append_instances, deploy_collection
from repro_torch.gopher import GopherService, GopherSession, QueryTicket
from repro_torch.gopher.service import DEFAULT_CACHE_BYTES

V, E, I, P, B = 64, 200, 5, 4, 16
WAIT = 120  # seconds: the longest any test waits on a service
INF = float(np.inf)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    w = rng.uniform(0.5, 2.0, (I, E)).astype(np.float32)
    plates = rng.integers(-1, 3, (I, V))
    assign = rng.integers(0, P, V)
    return src, dst, w, plates, assign


def _session(**kw):
    src, dst, w, plates, assign = _arrays()
    bg = build_blocked(GraphTemplate(num_vertices=V, src=src, dst=dst),
                       assign, block_size=B)
    return GopherSession.from_blocked(
        bg, weights={"latency": w}, vertex_attrs={"plate": plates},
        src=src, dst=dst, device="cpu", **kw)


def _jsession(**kw):
    src, dst, w, plates, assign = _arrays()
    bg = j_build_blocked(JGraphTemplate(num_vertices=V, src=src, dst=dst),
                         assign, block_size=B)
    return JGopherSession.from_blocked(
        bg, weights={"latency": w}, vertex_attrs={"plate": plates},
        src=src, dst=dst, **kw)


@pytest.fixture(scope="module")
def ref_session():
    """The reference's plain session: every service result is held
    against its run of the same query."""
    return _jsession()


@pytest.fixture()
def service():
    svc = GopherService(session=_session())
    yield svc.start()
    svc.stop()


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert np.array_equal(a, b), what


def _assert_same_output(ref, got, label=""):
    assert set(ref.output) == set(got.output), label
    for k in ref.output:
        a, b = ref.output[k], got.output[k]
        if isinstance(a, np.ndarray) or hasattr(a, "shape"):
            _bits(b, np.asarray(a), (label, k))
        else:
            assert a == b, (label, k)


def _ref(ref_session, name, **params):
    return ref_session.run(ref_session.plan(name, **params))


# --------------------------------------------------------------------------
# batching invisibility
# --------------------------------------------------------------------------

def test_batched_sssp_bitwise_matches_singles(service, ref_session):
    sources = [0, 7, 13, 42]
    outs = service.query_many([("sssp", {"source": s}) for s in sources],
                              timeout=WAIT)
    for s, o in zip(sources, outs):
        _bits(o.output["final"], _ref(ref_session, "sssp", source=s)
              .output["final"], s)
    assert service.report()["widest_batch"] == 4
    assert service.report()["batches"] == 1


def test_mixed_analytic_batch_matches_singles(service, ref_session):
    reqs = [("nhop", {"source": 3, "n_hops": 2}),
            ("sssp", {"source": 9}),
            ("nhop", {"source": 9, "n_hops": 2}),
            ("tracking", {"plate": 1, "initial_vertex": 0})]
    outs = service.query_many(reqs, timeout=WAIT)
    for (name, params), got in zip(reqs, outs):
        _assert_same_output(_ref(ref_session, name, **params), got, name)


def test_mismatched_params_not_merged(service, ref_session):
    reqs = [("sssp", {"source": 5, "max_supersteps": 64}),
            ("sssp", {"source": 5, "max_supersteps": 3})]
    outs = service.query_many(reqs, timeout=WAIT)
    for (name, params), got in zip(reqs, outs):
        _assert_same_output(_ref(ref_session, name, **params), got,
                            str(params))
    assert outs[0].plan.param_dict["source"] == 5  # not merged into a list


def test_sequence_source_request_passes_through(service, ref_session):
    got = service.query("sssp", source=[2, 4], timeout=WAIT)
    assert got.output["final"].shape[0] == 2
    _bits(got.output["final"],
          _ref(ref_session, "sssp", source=[2, 4]).output["final"])


# --------------------------------------------------------------------------
# warm staging cache
# --------------------------------------------------------------------------

def test_repeat_query_restages_nothing(service):
    service.query("sssp", source=1, timeout=WAIT)
    service.query("sssp", source=2, timeout=WAIT)
    rep = service.session.last_run_report
    assert rep["staged_bytes"] == 0
    assert rep["staging_passes"] == 0
    assert rep["cache_hits"] >= 1
    stats = service.session.staging_cache_stats()
    assert stats is not None and stats["resident_bytes"] > 0


def test_prestage_moves_staging_ahead_of_first_query(service):
    service.prestage("sssp", source=0)
    service.query("sssp", source=0, timeout=WAIT)
    rep = service.session.last_run_report
    assert rep["staged_bytes"] == 0 and rep["staging_passes"] == 0


def test_plain_session_is_promoted_to_warm():
    sess = _session()
    assert sess._staging_cache is None
    GopherService(session=sess)
    assert sess._staging_cache is not None
    assert sess._staging_cache.byte_budget == DEFAULT_CACHE_BYTES == 256 << 20


# --------------------------------------------------------------------------
# admission / continuous batching
# --------------------------------------------------------------------------

def test_submit_many_forms_one_admission(service):
    tickets = service.submit_many(
        [("sssp", {"source": s}) for s in range(5)])
    assert all(isinstance(t, QueryTicket) for t in tickets)
    for t in tickets:
        t.wait(timeout=WAIT)
    rep = service.report()
    assert rep["batches"] == 1 and rep["widest_batch"] == 5
    assert service.max_batch_queries == 32


def test_concurrent_submitters_each_get_their_answer(service, ref_session):
    refs = {s: _ref(ref_session, "sssp", source=s).output["final"]
            for s in range(6)}
    errors = []

    def client(s):
        try:
            out = service.query("sssp", source=s, timeout=WAIT)
            _bits(out.output["final"], refs[s], s)
        except Exception as e:  # reported below, not swallowed
            errors.append((s, e))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "client thread hung"
    assert not errors, errors
    rep = service.report()
    assert rep["served"] >= 6
    assert rep["p50_ms"] is not None and rep["p95_ms"] >= rep["p50_ms"]


def test_stop_drains_queued_requests():
    svc = GopherService(session=_session()).start()
    tickets = svc.submit_many([("sssp", {"source": s}) for s in range(3)])
    svc.stop()  # graceful: everything already queued is served
    for t in tickets:
        assert t.done and t.result is not None
        assert t.latency_s is not None and t.latency_s >= 0


# --------------------------------------------------------------------------
# request plumbing / errors
# --------------------------------------------------------------------------

def test_bad_requests_raise_on_caller_thread(service):
    with pytest.raises(KeyError, match="unknown analytic"):
        service.submit("ssssp", source=0)
    with pytest.raises(TypeError, match="unknown parameter"):
        service.submit("sssp", sourcee=0)
    with pytest.raises(TypeError, match="missing required"):
        service.submit("sssp")
    with pytest.raises(TypeError, match="unknown plan knob"):
        service.submit("sssp", source=0, plan_kw={"laoyut": "dense"})


def test_engine_failure_delivered_and_loop_survives(service):
    jsvc = JGopherService(session=_jsession()).start()
    try:
        with pytest.raises(Exception) as jerr:
            jsvc.query("sssp", source=10 ** 9, timeout=WAIT)
    finally:
        jsvc.stop()
    with pytest.raises(type(jerr.value)):
        service.query("sssp", source=10 ** 9, timeout=WAIT)
    out = service.query("sssp", source=0, timeout=WAIT)
    assert np.isfinite(out.output["final"][0])


def test_refresh_failure_reaches_tickets_and_subscriptions(service):
    """An exception on the loop thread outside a batch (here the refresh
    at the batch boundary) is raised by every ticket of that batch and by
    live subscriptions; the loop serves on."""
    sess = service.session
    real = sess.refresh
    sub = service.subscribe("sssp", source=0)
    sub.wait_update(1, timeout=WAIT)

    def broken():
        raise OSError("store went away")

    sess.refresh = broken
    try:
        with pytest.raises(OSError, match="went away"):
            service.query("sssp", source=1, timeout=WAIT)
        with pytest.raises(OSError, match="went away"):
            sub.wait_update(2, timeout=WAIT)
    finally:
        sess.refresh = real
        sub.cancel()
    out = service.query("sssp", source=0, timeout=WAIT)
    assert np.isfinite(out.output["final"][0])


def test_report_counts_match_reference():
    """The same admissions through both services give the same counts and
    the same staging-cache economy."""
    reqs = [[("sssp", {"source": s}) for s in (0, 3, 9)],
            [("nhop", {"source": 1, "n_hops": 2}),
             ("nhop", {"source": 5, "n_hops": 2}),
             ("sssp", {"source": 4})],
            [("tracking", {"plate": 2, "initial_vertex": 1})]]
    reps = []
    for svc in (GopherService(session=_session()),
                JGopherService(session=_jsession())):
        with svc:
            for batch in reqs:
                for t in svc.submit_many(batch):
                    t.wait(timeout=WAIT)
            reps.append(svc.report())
    got, want = reps
    for k in ("served", "batches", "widest_batch", "subscriptions",
              "appends_observed", "staging_cache"):
        assert got[k] == want[k], k


# --------------------------------------------------------------------------
# a tailing subscription over two appends
# --------------------------------------------------------------------------

SUB_CFG = GraphConfig(
    name="stream-sub", num_vertices=120, avg_degree=3.0, num_instances=6,
    num_partitions=3, block_size=16, instances_per_slice=2,
    bins_per_partition=2, cache_slots=6, seed=3)


def _monotone(cfg, seed=0):
    """A collection whose latencies only tighten (tests/
    test_streaming_stress.py's recipe): warm and cold tails agree."""
    col = generate_collection(cfg)
    rng = np.random.default_rng(seed)
    n_e = np.asarray(col.template.src).shape[0]
    ws = [np.asarray(col.edge_values(0, "latency"), np.float32)]
    for _t in range(1, len(col)):
        f = np.where(rng.random(n_e) < 0.3, rng.uniform(0.6, 1.0, n_e), 1.0)
        ws.append((ws[-1] * f).astype(np.float32))
    return TimeSeriesGraph(template=col.template, instances=[
        dataclasses.replace(col.instances[t], edge_values={
            **col.instances[t].edge_values, "latency": ws[t]})
        for t in range(len(col))])


def _part(col, lo, hi):
    return TimeSeriesGraph(template=col.template,
                           instances=col.instances[lo:hi])


def test_subscription_over_two_appends_matches_reference(tmp_path):
    col = _monotone(SUB_CFG)
    root = str(tmp_path / "live")
    deploy_collection(_part(col, 0, 3), SUB_CFG, root,
                      sparse_absent={"latency": INF})
    svc = GopherService(GoFSStore(root), block_size=SUB_CFG.block_size,
                        device="cpu", poll_interval=0.01)
    jsvc = JGopherService(JGoFSStore(root), block_size=SUB_CFG.block_size,
                          poll_interval=0.01)
    got = []
    with svc, jsvc:
        subs = [s.subscribe("sssp", source=0) for s in (svc, jsvc)]
        for n, (lo, hi) in enumerate(((None, None), (3, 5), (5, 6)), 1):
            if lo is not None:
                append_instances(_part(col, lo, hi), root)
            got.append([s.wait_update(n, timeout=WAIT) for s in subs])
        reps = [s.report() for s in (svc, jsvc)]
        for s in subs:
            s.cancel()
    assert [u.mode for u, _ in got] == ["full", "incremental",
                                        "incremental"]
    assert [u.new_instances for u, _ in got] == [3, 2, 1]
    for u, ju in got:
        assert (u.mode, u.new_instances, u.version) == \
            (ju.mode, ju.new_instances, ju.version)
        for k, v in ju.result.output.items():
            _bits(u.result.output[k], np.asarray(v), k)
        for k, v in ju.result.engine.stats.items():
            _bits(u.result.engine.stats[k], np.asarray(v), k)
    assert reps[0]["appends_observed"] == reps[1]["appends_observed"] == 2
    cold = GopherSession(GoFSStore(root), block_size=SUB_CFG.block_size,
                         device="cpu")
    ref = cold.run(cold.plan("sssp", source=0))
    _bits(got[-1][0].result.output["final"], ref.output["final"])


def test_auto_refresh_off_pins_the_version(tmp_path):
    """``auto_refresh=False``, as the reference: the loop never polls, so
    an append is not observed, no subscription takes a tail step, and
    queries are answered on the version the service opened on."""
    col = _monotone(SUB_CFG)
    root = str(tmp_path / "pinned")
    deploy_collection(_part(col, 0, 3), SUB_CFG, root,
                      sparse_absent={"latency": INF})
    svc = GopherService(GoFSStore(root), block_size=SUB_CFG.block_size,
                        device="cpu", poll_interval=0.01,
                        auto_refresh=False)
    jsvc = JGopherService(JGoFSStore(root), block_size=SUB_CFG.block_size,
                          poll_interval=0.01, auto_refresh=False)
    assert svc.auto_refresh is False
    with svc, jsvc:
        subs = [s.subscribe("sssp", source=0) for s in (svc, jsvc)]
        before = [s.query("sssp", source=0, timeout=WAIT)
                  for s in (svc, jsvc)]
        append_instances(_part(col, 3, 5), root)
        time.sleep(0.1)  # a few poll ticks of an auto-refreshing loop
        after = [s.query("sssp", source=0, timeout=WAIT)
                 for s in (svc, jsvc)]
        reps = [s.report() for s in (svc, jsvc)]
        delivered = [sub.delivered for sub in subs]
        for sub in subs:
            sub.cancel()
    assert delivered == [0, 0]
    assert reps[0]["appends_observed"] == reps[1]["appends_observed"] == 0
    for got, want in zip(after, before):
        assert got.engine.values.shape[-2] == 3  # the pre-append version
    for res in (before, after):
        for k, v in res[1].output.items():
            _bits(res[0].output[k], np.asarray(v), k)
    # a built session is accepted with the option, as in the reference
    svc = GopherService(session=_session(), auto_refresh=False)
    assert svc.auto_refresh is False and not svc.session.refresh()


def test_group_key_merges_equal_values_of_other_dtypes():
    """Requests whose non-source parameters hold equal values merge into
    one pass whatever the arrays' dtypes, as in the reference: N-hop bins
    as float64 and as int64 give one Q = 2 plan."""
    b = np.array([0, 10, 20, 50, 100, 200, 500, 1000, 2000], np.float64)
    reqs = [("nhop", {"source": 1, "n_hops": 2, "bins": b}),
            ("nhop", {"source": 5, "n_hops": 2,
                      "bins": b.astype(np.int64)})]
    outs = []
    for svc in (GopherService(session=_session()),
                JGopherService(session=_jsession())):
        with svc:
            outs.append([t.wait(timeout=WAIT)
                         for t in svc.submit_many(reqs)])
    got, want = outs
    for g, w in zip(got, want):
        assert g.plan.param_dict["source"] == w.plan.param_dict["source"] \
            == (1, 5)
        _assert_same_output(w, g, "nhop")


# --------------------------------------------------------------------------
# tests/test_streaming_stress.py on the port
# --------------------------------------------------------------------------

STRESS_CFG = GraphConfig(
    name="stress-stream", num_vertices=256, avg_degree=3.0,
    num_instances=8, num_partitions=2, block_size=16,
    instances_per_slice=2, cache_slots=8, seed=23)
PREFIX, BUDGET = 4, 64 << 20
KNOBS = {"layout": "dense", "warm": False, "staging": "sync"}


@pytest.mark.slow
def test_streaming_appender_vs_queries_vs_subscriber(tmp_path):
    col = _monotone(STRESS_CFG, seed=STRESS_CFG.seed)
    total = len(col)
    refs = {}
    for n in range(PREFIX, total + 1):
        root_n = str(tmp_path / f"ref_{n}")
        deploy_collection(_part(col, 0, n), STRESS_CFG, root_n,
                          sparse_absent={"latency": INF})
        cold = GopherSession(GoFSStore(root_n), device="cpu",
                             block_size=STRESS_CFG.block_size)
        refs[n] = cold.run(cold.plan("sssp", source=0, **KNOBS))
    live = str(tmp_path / "live")
    deploy_collection(_part(col, 0, PREFIX), STRESS_CFG, live,
                      sparse_absent={"latency": INF})
    stop = threading.Event()
    results, errors, updates = [], [], []

    with GopherService(GoFSStore(live), block_size=STRESS_CFG.block_size,
                       device="cpu", poll_interval=0.01,
                       staging_cache_bytes=BUDGET) as svc:
        sub = svc.subscribe("sssp", source=0, plan_kw=dict(KNOBS),
                            callback=updates.append)
        sub.wait_update(1, timeout=WAIT)

        def querier():
            try:
                while not stop.is_set():
                    results.append(svc.query(
                        "sssp", source=0, plan_kw=dict(KNOBS), timeout=WAIT))
            except Exception as e:  # surfaced below, not swallowed
                errors.append(e)

        threads = [threading.Thread(target=querier, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        for k in range(PREFIX, total):
            append_instances(_part(col, k, k + 1), live)
            time.sleep(0.05)
        deadline = time.time() + WAIT
        while time.time() < deadline:
            u = sub.last
            if u is not None and sub.error is None and int(
                    np.asarray(u.result.engine.values).shape[-2]) == total:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"subscriber never caught up to {total} instances "
                        f"(last={sub.last and sub.last.mode}, "
                        f"err={sub.error})")
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads), "query thread hung"
        assert not errors, errors
        stats = svc.session.staging_cache_stats()
        rep = svc.report()
        sub.cancel()

    assert sub.error is None
    assert rep["appends_observed"] >= 1
    assert results, "query threads produced nothing"
    for res in results:
        vals = np.asarray(res.engine.values)
        n = int(vals.shape[-2])
        assert n in refs, f"result over {n} instances matches no version"
        rv = np.asarray(refs[n].engine.values)
        if vals.ndim == rv.ndim + 1:
            assert all(np.array_equal(v, rv) for v in vals), n
        else:
            _bits(vals, rv, f"torn read at version n={n}")
        _bits(np.asarray(res.output["final"]), refs[n].output["final"])
    last = updates[-1]
    assert int(np.asarray(last.result.engine.values).shape[-2]) == total
    _bits(last.result.output["final"], refs[total].output["final"])
    modes = [u.mode for u in updates]
    assert modes[0] == "full" and set(modes[1:]) <= {"incremental"}
    assert sum(u.new_instances for u in updates
               if u.mode == "incremental") == total - PREFIX
    assert stats is not None
    assert stats["resident_bytes"] <= BUDGET
    assert stats["byte_budget"] == BUDGET
    jcold = JGopherSession(JGoFSStore(live),
                           block_size=STRESS_CFG.block_size)
    _bits(last.result.output["final"], np.asarray(jcold.run(jcold.plan(
        "sssp", source=0, **KNOBS)).output["final"]))


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

def test_run_graph_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import run_graph

    root = str(tmp_path / "rg")
    run_graph.main(["--size", "tiny", "--device", "cpu", "--deploy", root])
    run_graph.main(["--size", "tiny", "--engine", "host", "--deploy", root])
    out = capsys.readouterr().out
    reached = [line for line in out.splitlines() if "SSSP reached" in line]
    assert len(reached) == 2
    assert "sssp/blocked done" in out and "sssp/host done" in out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        # the default engine is the blocked one, on the card
        run_graph.main(["--size", "tiny", "--deploy", root])


def test_serve_graph_cli_on_the_cpu(tmp_path):
    from repro_torch.launch import serve_graph

    rep = serve_graph.main(["--size", "tiny", "--queries", "12",
                            "--clients", "4", "--device", "cpu",
                            "--deploy", str(tmp_path / "sg")])
    assert rep["served"] == 12 + 2  # and the two warm-up queries
    assert rep["staging_cache"]["hits"] > 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_graph.main(["--size", "tiny", "--deploy",
                          str(tmp_path / "sg")])


def test_tail_graph_cli_on_the_cpu(tmp_path):
    from repro_torch.launch import tail_graph

    out = tail_graph.main(["--size", "tiny", "--prefix", "1", "--batch",
                           "2", "--interval", "0.01", "--fresh", "--device",
                           "cpu", "--deploy", str(tmp_path / "tg")])
    modes = [u.mode for u in out["updates"]]
    assert modes[0] == "full" and set(modes[1:]) == {"incremental"}
    assert out["report"]["appends_observed"] >= 1
    assert os.path.exists(str(tmp_path / "tg" / "collection.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tail_graph.main(["--size", "tiny", "--prefix", "1", "--fresh",
                         "--deploy", str(tmp_path / "tg")])
