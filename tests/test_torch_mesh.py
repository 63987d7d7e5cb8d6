"""Multi-GPU placement of the port (``mesh=``), on the CPU with gloo ranks,
against the JAX package's STACKED engine (its own mesh runner fails on
this jax; ROADMAP §3).

Each mesh shape — (data, model) = (1, 2), (2, 1), (2, 2), (1, 4) — runs
as that many rank processes of ``tests/torch_mesh_worker.py`` (torch,
numpy and the port only; a ``file://`` rendezvous under the test's
temporary directory), every rank calling the same entry points with the
same inputs: ``tests/test_temporal.py``'s collection (500 vertices, 4
instances, 4 partitions, B = 32).  The JAX side runs here.

* Min-plus (SSSP under the three patterns, Q = 1 and Q = 4, dense and
  sparse, sync and async, spmv and fused modes, every comm; the five
  ``run_blocked`` wrappers; a ±0 collection with -0 seeds and a NaN
  weight): ``values``, ``final``, supersteps and local sweeps bitwise,
  the sign of zero and the NaN pattern included.
* Plus-mul (PageRank): within rtol 1e-6 of the reference (the port's
  stacked SpMV already differs from it in the last bit), and bitwise
  equal to the port's stacked engine, which the exchange happens to give
  here — each boundary slot has one publishing partition, so the
  boundary sum adds exact zeros; ``merged`` within 1e-6 (its data
  reduction reassociates the instance sum).
* ``pagerank_temporal``: within 1e-4 of ``pagerank.oracle`` per instance
  and for ``merged``, within 1e-6 of the stacked ``run_blocked``.
* Every rank returns the same, global, result; each fills only its
  shard, in memory and streamed from a GoFS deployment of the same
  collection through ``GopherSession(store, mesh=...)``; plans equal the
  reference's but for the kernel line.
* ``make_spmd_superstep`` against the reference's stacked superstep
  primitives (``repro.core.superstep``) on the same inputs.
"""
import collections
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.configs.base import GraphConfig as JGraphConfig
from repro.core import comm as j_comm
from repro.core import superstep as j_superstep
from repro.core.algorithms import components as j_components
from repro.core.algorithms import nhop as j_nhop
from repro.core.algorithms import pagerank as j_pagerank
from repro.core.algorithms import sssp as j_sssp
from repro.core.algorithms import tracking as j_tracking
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.core.semiring import PLUS_MUL as J_PLUS_MUL
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
from repro.gopher import GopherSession as JGopherSession
from repro.launch import mesh as j_mesh
from repro_torch.configs.base import GraphConfig
from repro_torch.core import comm as C
from repro_torch.core.blocked import build_blocked
from repro_torch.core.engine import pagerank_program, sources_init
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
from repro_torch.core.superstep import (_consume, _local_sweep, _publish,
                                        device_graph)
from repro_torch.dist.collectives import boundary_exchange_bytes
from repro_torch.launch import mesh as t_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
IDS = [f"{d}x{m}" for d, m in MESHES]
CFG = dict(name="t", num_vertices=500, avg_degree=3.0, num_instances=4,
           num_partitions=4, block_size=32, seed=7)
SOURCES = [0, 7, 42, 99]
ZERO_SOURCES = [0, 5, 17]
COMMS = ("dense", "ring", "ring-rs")
WAIT = 240.0  # seconds a mesh may take, start-up included
PLUS_MUL_MERGED_RTOL = 1e-6  # tests/test_comm_backends.py:196


def _same_bits(got, want):
    """NaN where ``want`` has NaN; every other entry bit for bit."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


def _engine_close(got, want, rtol=PLUS_MUL_MERGED_RTOL):
    """A plus-mul port result against a reference ``EngineResult``:
    values, final and merged within ``rtol``, counts equal."""
    _close(got["values"], want.values, rtol)
    _close(got["final"], want.final, rtol)
    assert np.array_equal(got["supersteps"],
                          np.asarray(want.stats["supersteps"]))
    if want.merged is not None:
        _close(got["merged"], want.merged, rtol)


def _engine_bitwise(got, want, merged_rtol=PLUS_MUL_MERGED_RTOL):
    """A port result (the worker's dict) against a reference
    ``EngineResult``: values, final and counts bitwise; merged within
    ``merged_rtol``."""
    _same_bits(got["values"], want.values)
    _same_bits(got["final"], want.final)
    for k in ("supersteps", "local_sweeps"):
        assert np.array_equal(got[k], np.asarray(want.stats[k])), k
    if want.merged is not None:
        with np.errstate(invalid="ignore"):
            _close(got["merged"], want.merged, merged_rtol)


# ---------------------------------------------------------------------------
# inputs, the reference, and the mesh runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    col = generate_collection(GraphConfig(**CFG), num_plates=12)
    t = col.template
    bg = build_blocked(t, partition_graph(t, 4, seed=7), 32)
    jcol = j_generate(JGraphConfig(**CFG), num_plates=12)
    jt = jcol.template
    jbg = j_build_blocked(jt, j_partition(jt, 4, seed=7), 32)
    I, V = len(col), t.num_vertices
    lat = np.stack([col.edge_values(i, "latency") for i in range(I)])
    act = np.stack([col.edge_values(i, "active") for i in range(I)])
    plates = np.stack([col.vertex_values(i, "plate")
                       for i in range(I)]).astype(np.int64)
    plate = 7
    seen = np.nonzero(plates[0] == plate)[0]
    rng = np.random.default_rng(11)
    zw = np.where(np.isfinite(lat), np.where(rng.random(lat.shape) < 0.5,
                                             -0.0, 0.0), np.inf)
    nw = zw.copy()
    nw[0, rng.choice(lat.shape[1], 5, replace=False)] = np.nan
    prw = j_pagerank.edge_weights_for_instances(t.src, act, V)
    special = np.array([0.0, -0.0, np.inf, 1.5, np.nan, 2.0], np.float32)
    bufs = {"min": rng.choice(special, (2, 4, 64)).astype(np.float32),
            "sum": rng.random((4, 64)).astype(np.float32)}
    pr0 = np.where(bg.global_of >= 0, 1.0 / V, 0.0).astype(np.float32)
    inputs = dict(
        bg=bg, lat=lat.astype(np.float32), act=act, prw=prw,
        src=t.src, dst=t.dst, plates=plates, plate=plate,
        start=int(seen[0]) if len(seen) else 0,
        zw=zw.astype(np.float32), nw=nw.astype(np.float32),
        zero_sources=ZERO_SOURCES, buf=bufs,
        x0={"min_plus": sources_init([0, 7])(bg), "plus_mul": pr0},
        store=str(tmp_path_factory.mktemp("mesh_gofs")))
    # one instance a slice: a streamed pass reads a chunk an instance
    j_deploy(jcol, JGraphConfig(**dict(CFG, instances_per_slice=1)),
             inputs["store"])
    return dict(inputs, jbg=jbg, jcol=jcol, V=V)


@pytest.fixture(scope="module")
def ref(env):
    """The JAX package's stacked engine on every distinct run."""
    jbg, lat, prw = env["jbg"], env["lat"], env["prw"]
    eng = J.TemporalEngine(jbg)

    def sssp(sources=None, **kw):
        init = J.source_init(0) if sources is None \
            else J.sources_init(sources)
        return J.min_plus_program("sssp", init=init, **kw)

    out = {}
    for pat in ("sequential", "independent", "eventually"):
        merge = "mean" if pat == "eventually" else None
        out[f"sssp/{pat}"] = eng.run(sssp(), lat, pattern=pat, merge=merge)
    for pat in ("sequential", "eventually"):
        merge = "mean" if pat == "eventually" else None
        out[f"query/{pat}"] = eng.run(sssp(SOURCES), lat, pattern=pat,
                                      merge=merge)
    out["warm"] = eng.run(sssp(), lat, pattern="independent",
                          warm_start=True)
    out["vertex_centric"] = eng.run(sssp(subgraph_centric=False), lat,
                                    pattern="sequential")
    pp = J.pagerank_program(env["V"], iters=10)
    out["pagerank/eventually"] = eng.run(pp, prw, pattern="eventually",
                                         merge="mean")
    out["pagerank/sequential"] = eng.run(pp, prw, pattern="sequential")
    zinit = _j_negative_zero_init(ZERO_SOURCES)
    for pat in ("sequential", "independent"):
        out[f"zero/{pat}"] = eng.run(J.min_plus_program("sssp", init=zinit),
                                     env["zw"], pattern=pat)
    out["nan"] = eng.run(J.min_plus_program(
        "sssp", init=zinit, max_supersteps=4, max_local_sweeps=6),
        env["nw"], pattern="sequential")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out["w/sssp"] = j_sssp.run_blocked(jbg, lat, 0)
        out["w/pagerank"] = j_pagerank.run_blocked(
            jbg, env["src"], env["act"], num_vertices=env["V"], iters=10)
        out["w/nhop"] = j_nhop.run_blocked(jbg, lat, 0, 4)
        out["w/components"] = j_components.run_blocked_temporal(
            jbg, env["src"], env["dst"], env["act"])
        out["w/tracking"] = j_tracking.run_blocked(
            jbg, env["plates"], env["plate"], env["start"], search_depth=4)
        out["w/pagerank12"] = j_pagerank.run_blocked(
            jbg, env["src"], env["act"], num_vertices=env["V"], iters=12)[0]
    return out


@pytest.fixture(scope="module")
def port_ref(env):
    """The port's stacked engine on the plus-mul runs."""
    from repro_torch.core.engine import TemporalEngine

    eng = TemporalEngine(env["bg"], device="cpu")
    pp = pagerank_program(env["V"], iters=10)
    return {"eventually": eng.run(pp, env["prw"], pattern="eventually",
                                  merge="mean"),
            "sequential": eng.run(pp, env["prw"], pattern="sequential")}


def _j_negative_zero_init(sources):
    def init(bg):
        x0 = np.stack([bg.scatter_vertex(
            np.full(bg.part_of.shape, np.inf, np.float32), np.inf)
            for _ in sources])
        for q, s in enumerate(sources):
            x0[q, bg.part_of[s], bg.local_of[s]] = -0.0
        return x0

    return init


def _launch(tmp, shape, cases):
    """Start one mesh's ranks; returns (processes, output paths)."""
    data, model = shape
    world = data * model
    tag = f"{data}x{model}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(tmp, f"{tag}_rank{r}.pkl")
        spec = dict(rank=r, world=world, data=data, model=model,
                    init=f"file://{os.path.join(tmp, tag + '_rdv')}",
                    inputs=os.path.join(tmp, "inputs.pkl"), out=out,
                    cases=cases, timeout=120)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, json.dumps(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    return procs, outs


@pytest.fixture(scope="module")
def runs(env, tmp_path_factory):
    """Every mesh shape's ranks, all started at once; {shape: [each
    rank's results]}.  A rank that fails or outlives WAIT fails the
    tests of its shape only."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in env.items()
                     if k not in ("jbg", "jcol", "V")}, f)
    cases = ["patterns", "query", "layouts", "pagerank", "signed_zero",
             "wrappers", "session", "store", "temporal", "spmd", "comm",
             "fills"]
    started = {s: _launch(tmp, s, cases) for s in MESHES}
    got = {}
    for shape, (procs, outs) in started.items():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=WAIT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append("timed out")
        if all(p.returncode == 0 for p in procs):
            got[shape] = []
            for o in outs:
                with open(o, "rb") as f:
                    got[shape].append(pickle.load(f))
        else:
            got[shape] = "\n".join(logs)[-4000:]
    return got


def _case(runs, shape, name):
    """Rank 0's results of one case, after checking the shape ran."""
    r = runs[shape]
    assert not isinstance(r, str), r
    res = r[0][name]
    assert "error" not in res, res["error"]
    return res


def _eq_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "local":
                _eq_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind == "f":
            nan = np.isnan(a)
            assert np.array_equal(nan, np.isnan(b)) and np.array_equal(
                a[~nan].view(np.int32), b[~nan].view(np.int32)), path
        else:
            assert np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert a == b, path
    else:
        assert a == b or (a != a and b != b), path


def test_eq_tree_names_the_differing_entry():
    with pytest.raises(AssertionError, match="/x/y"):
        _eq_tree({"x": {"y": 1}}, {"x": {"y": 2}})
    with pytest.raises(AssertionError, match="/z"):
        _eq_tree({"z": np.float32([0.0])}, {"z": np.float32([-0.0])})


# ---------------------------------------------------------------------------
# tests over every mesh shape
# ---------------------------------------------------------------------------

pytestmark_shapes = pytest.mark.parametrize("shape", MESHES, ids=IDS)


@pytestmark_shapes
def test_every_rank_returns_the_same_global_result(runs, shape):
    r = runs[shape]
    assert not isinstance(r, str), r
    for name, res in r[0].items():
        assert "error" not in res, (name, res["error"])
    for other in r[1:]:
        _eq_tree(r[0], other)


@pytestmark_shapes
def test_patterns_bitwise(runs, ref, shape):
    """Every pattern under every comm, bitwise; the rings' loops sync over
    data (``bind_sync``) exactly when the pass shards its instances."""
    got = _case(runs, shape, "patterns")
    data = shape[0]
    for comm in COMMS:
        for pat in ("sequential", "independent", "eventually"):
            g = got[f"{comm}/{pat}"]
            _engine_bitwise(g, ref[f"sssp/{pat}"])
            sharded = data > 1 and pat != "sequential"
            assert (g["synced_votes"] > 0) == (sharded and comm != "dense")


@pytestmark_shapes
def test_query_axis_bitwise(runs, ref, shape):
    got = _case(runs, shape, "query")
    for comm in COMMS:
        for pat in ("sequential", "eventually"):
            g = got[f"{comm}/{pat}"]
            assert g["values"].shape[0] == len(SOURCES)
            _engine_bitwise(g, ref[f"query/{pat}"])


@pytestmark_shapes
def test_layouts_staging_and_modes_bitwise(runs, ref, shape):
    got = _case(runs, shape, "layouts")
    for pat in ("sequential", "independent"):
        _engine_bitwise(got[f"sparse/{pat}"], ref[f"sssp/{pat}"])
        _engine_bitwise(got[f"async/{pat}"], ref[f"sssp/{pat}"])
        q = ref["query/sequential" if pat == "sequential"
                else "query/eventually"]
        _same_bits(got[f"fused/{pat}"]["values"], q.values)
        for k in ("supersteps", "local_sweeps"):
            assert np.array_equal(got[f"fused/{pat}"][k], q.stats[k])
    a = got["async_sparse/independent"]
    _same_bits(a["values"], ref["query/eventually"].values)
    for k in ("sparse/sequential", "sparse/independent",
              "prestaged_sparse/independent", "async_sparse/independent"):
        assert 0.0 < got[k]["occupancy"] <= 1.0
    assert got["sparse/independent"]["occupancy"] == pytest.approx(
        got["prestaged_sparse/independent"]["occupancy"], abs=0)
    _engine_bitwise(got["warm/independent"], ref["warm"])
    _engine_bitwise(got["vertex_centric/sequential"], ref["vertex_centric"])
    _engine_bitwise(got["prestaged/independent"], ref["sssp/independent"])
    _engine_bitwise(got["prestaged_sparse/independent"],
                    ref["sssp/independent"])


@pytestmark_shapes
def test_pagerank_plus_mul(runs, ref, port_ref, shape):
    """Within 1e-6 of the reference; ranks bitwise the port's stacked
    engine's (the exchange adds exact zeros here, module docstring),
    ``merged`` within 1e-6 of it."""
    got = _case(runs, shape, "pagerank")
    want, mine = ref["pagerank/eventually"], port_ref["eventually"]
    for comm in COMMS:
        _engine_close(got[f"{comm}/eventually"], want)
        _engine_bitwise(got[f"{comm}/eventually"], mine)
    _close(got["async/independent"]["values"], want.values, 1e-6)
    _same_bits(got["async/independent"]["values"], mine.values)
    _engine_close(got["sparse/sequential"], ref["pagerank/sequential"])
    _engine_bitwise(got["sparse/sequential"], port_ref["sequential"])


@pytestmark_shapes
def test_signed_zeros_and_nan_bitwise(runs, ref, shape):
    got = _case(runs, shape, "signed_zero")
    for comm in COMMS:
        for pat in ("sequential", "independent"):
            g, w = got[f"zero/{comm}/{pat}"], ref[f"zero/{pat}"]
            vals = np.asarray(w.values)
            assert np.any(np.signbit(vals) & (vals == 0))
            assert np.any(~np.signbit(vals) & (vals == 0))
            _engine_bitwise(g, w)
        g = got[f"nan/{comm}/sequential"]
        assert np.isnan(g["values"]).any()
        _engine_bitwise(g, ref["nan"])


@pytestmark_shapes
def test_run_blocked_wrappers(runs, ref, shape):
    got = _case(runs, shape, "wrappers")
    final, ss, lsw = got["sssp"]
    jf, jst = ref["w/sssp"]
    _same_bits(final, jf)
    assert np.array_equal(ss, jst["supersteps"])
    assert np.array_equal(lsw, jst["local_sweeps"])
    ranks, pss = got["pagerank"]
    _close(ranks, ref["w/pagerank"][0], 1e-6)
    assert np.array_equal(pss, np.asarray(ref["w/pagerank"][1]))
    for a, b in zip(got["nhop"], ref["w/nhop"]):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(got["components"], ref["w/components"])
    assert got["tracking"] == ref["w/tracking"]


@pytestmark_shapes
def test_session_plans_and_runs(runs, ref, env, shape):
    """Plans equal a reference session's on the same placement field by
    field, but for the kernel knob's reason (both ``off`` on the CPU);
    runs bitwise."""
    got = _case(runs, shape, "session")
    data, model = shape
    fake = types.SimpleNamespace(
        axis_names=("data", "model"),
        shape=collections.OrderedDict(data=data, model=model))
    js = JGopherSession.from_blocked(
        env["jbg"], weights={"latency": env["lat"], "active": env["act"]},
        src=env["src"], dst=env["dst"], mesh=fake)
    want = {"sssp": js.plan("sssp", source=0),
            "sssp_q": js.plan("sssp", source=SOURCES[:3]),
            "pagerank": js.plan("pagerank", iters=10),
            "sssp_ring": js.plan("sssp", source=0, comm="ring",
                                 layout="sparse")}
    for k, j in want.items():
        p = got["plans"][k]
        assert p.placement.value == f"mesh{{'data': {data}, 'model': {model}}}"
        for f in dataclasses.fields(j):
            a, b = getattr(p, f.name), getattr(j, f.name)
            if f.name == "kernel":
                assert a.value == b.value == "off"
            elif hasattr(b, "value"):
                assert (a.value, a.source, a.reason) == \
                    (b.value, b.source, b.reason), (k, f.name)
            else:
                assert a == b, (k, f.name)
        lines = got["explain"][k].splitlines()
        jlines = j.explain().splitlines()
        assert len(lines) == len(jlines)
        for a, b in zip(lines, jlines):
            if not a.lstrip().startswith("kernel"):
                assert a == b
    _engine_bitwise(got["sssp"], ref["sssp/sequential"])
    _close(got["pagerank"]["values"], ref["pagerank/eventually"].values,
           1e-6)
    _same_bits(got["sssp_q"], ref["query/sequential"].final[:3])
    _engine_bitwise(got["sssp_ring"], ref["sssp/sequential"])


@pytestmark_shapes
def test_pagerank_temporal(runs, ref, env, shape):
    """``tests/test_temporal.py``'s script on the port: within 1e-4 of the
    oracle per instance and for ``merged``, within 1e-6 of the stacked
    ``run_blocked``."""
    got = _case(runs, shape, "temporal")
    oracles = np.stack([
        j_pagerank.oracle(env["src"], env["dst"], env["act"][t], env["V"],
                          iters=12) for t in range(4)])
    serial = ref["w/pagerank12"]
    for key in COMMS + ("runner",):
        ranks, merged = got[key]
        if key == "runner":  # (I, P, Vp) / (P, Vp) on the blocked layout
            bg = env["bg"]
            ranks = ranks[:, bg.part_of, bg.local_of]
            merged = merged[bg.part_of, bg.local_of]
        for t in range(4):
            err = np.abs(ranks[t] - oracles[t]).max() / oracles[t].max()
            assert err < 1e-4, (key, t, err)
        m = oracles.mean(0)
        assert np.abs(merged - m).max() / m.max() < 1e-4, key
        assert np.abs(serial - ranks).max() < 1e-6, key


@pytestmark_shapes
def test_spmd_superstep(runs, env, shape):
    """One superstep over every mesh dim equals the JAX package's stacked
    superstep (``repro.core.superstep``'s sweep, publish through the
    unbound dense fold, and consume, lane by lane): min-plus bitwise
    (Q = 2), plus-mul within 1e-6; and the port's stacked superstep, on
    the same inputs, the same way."""
    got = _case(runs, shape, "spmd")
    bg, jbg = env["bg"], env["jbg"]
    assert np.array_equal(bg.global_of, jbg.global_of)
    for sr, jsr, w, zero in ((MIN_PLUS, J_MIN_PLUS, env["lat"], np.inf),
                             (PLUS_MUL, J_PLUS_MUL, env["prw"], 0.0)):
        jdg = j_superstep.device_graph(
            jbg, jbg.fill_local_batch(w[:1], zero=zero)[0],
            jbg.fill_boundary_batch(w[:1], zero=zero)[0])
        x0 = env["x0"][sr.name]
        lanes = x0 if x0.ndim == 3 else x0[None]
        want = []
        for x in lanes:
            x1 = j_superstep._local_sweep(x, jdg, jsr, False)
            b = j_superstep._publish(x1, jdg, jsr, j_comm.make_comm("dense"))
            want.append(np.asarray(j_superstep._consume(x1, b, jdg, jsr,
                                                        False)))
        want = np.stack(want) if x0.ndim == 3 else want[0]
        dg = device_graph(bg, bg.fill_local_batch(w[:1], zero=zero)[0],
                          bg.fill_boundary_batch(w[:1], zero=zero)[0],
                          device="cpu")
        x = torch.as_tensor(x0)
        x1 = _local_sweep(x, dg, sr, "off")
        mine = _consume(x1, _publish(x1, dg, sr, C.DenseAllReduce()), dg,
                        sr, "off").numpy()
        for comm in COMMS:
            g = got[f"{sr.name}/{comm}"]
            if sr is MIN_PLUS:
                assert g.shape[0] == 2
                _same_bits(g, want)
                _same_bits(g, mine)
            else:
                _close(g, want, 1e-6)
                _close(g, mine, 1e-6)


@pytest.fixture(scope="module")
def store_ref(env):
    """The JAX package's session on the mesh tests' GoFS deployment."""
    js = JGopherSession(JGoFSStore(env["store"]))
    return {
        "stream_sequential": js.run(js.plan("sssp", source=0,
                                            staging="async")),
        "stream_independent": js.run(js.plan(
            "sssp", source=0, staging="async", pattern="independent")),
        "stream_pagerank": js.run(js.plan("pagerank", iters=10,
                                          staging="async")),
        "sync_sequential": js.run(js.plan("sssp", source=0,
                                          staging="sync")),
    }


@pytestmark_shapes
def test_store_session_fills_its_shard(runs, store_ref, shape):
    """``GopherSession(store, mesh=...)``: streamed SSSP, streamed
    PageRank and sync SSSP equal the reference session's (min-plus
    bitwise, plus-mul within 1e-6); each rank fills only its partitions
    (P / model) and, on a streamed temporally concurrent pass, only its
    instances (I / data), one chunk an instance, in one staging pass."""
    data, model = shape
    got = _case(runs, shape, "store")
    for k in ("stream_sequential", "stream_independent", "sync_sequential"):
        _engine_bitwise(got[k], store_ref[k].engine)
    _engine_close(got["stream_pagerank"], store_ref["stream_pagerank"].engine)
    for res in runs[shape]:
        local = res["store"]["local"]
        for k, rec in local.items():
            if k == "exchange":
                continue
            assert rec["staging_passes"] == 1, k
            assert {p for _, p in rec["fills"]} == {4 // model}, (k, rec)
        assert local["sync_sequential"]["fills"] == [(4, 4 // model)]
        assert local["stream_sequential"]["fills"] == [(1, 4 // model)] * 4
        for k in ("stream_independent", "stream_pagerank"):
            assert local[k]["fills"] == [(1, 4 // model)] * (4 // data), k


@pytestmark_shapes
def test_comm_backends_on_the_mesh(runs, env, shape):
    """The backends over a buffer split across the model group: min-plus
    bitwise with ±0, NaN and inf (the reference's stacked fold, lane by
    lane), plus-mul within 1e-6; the votes, the sum, the ring's synced
    continuation; ``make_comm``'s validations as the reference's."""
    got = _case(runs, shape, "comm")
    buf = env["buf"]
    want_min = np.stack([np.asarray(j_comm.make_comm("dense")
                                    .combine_boundary(b, J_MIN_PLUS))
                         for b in buf["min"]])
    want_sum = np.asarray(j_comm.make_comm("dense").combine_boundary(
        buf["sum"], J_PLUS_MUL))
    for comm in COMMS:
        _same_bits(got[f"min/{comm}"], want_min)
        for rank in runs[shape]:
            _close(rank["comm"]["local"][f"sum/{comm}"], want_sum, 1e-6)
    data, model = shape
    # each combine's bytes: the cost model's for the rings (every hop a
    # whole buffer, or a 1/n chunk twice), what the collective is handed
    # for the dense form (a lane-stacked partial for min-plus)
    nb = buf["sum"].shape[-1] * 4
    for name, lanes in (("min", 2), ("sum", 1)):
        for comm in ("ring", "ring-rs"):
            model_bytes = boundary_exchange_bytes(
                buf["sum"].shape[-1], model, comm)["bytes_per_device"]
            assert got[f"bytes/{name}/{comm}"] == lanes * model_bytes
        assert got[f"bytes/{name}/dense"] == lanes * nb
    assert list(got["any_changed"]) == [True, False, True]
    assert list(got["local_vote"]) == [True, False, True]
    assert got["sum_scalar"] == sum(range(1, model + 1))
    assert got["keep_running"] is True
    assert got["prebuilt"] == (("model",), (model,), True, True)
    errs = got["errors"]
    for key, match in (("unbound", "unbound"), ("host", "mesh-free"),
                       ("host_instance", "mesh-free"),
                       ("no_mesh", "no mesh was given"),
                       ("axes", "only has axes"),
                       ("sizes", "do not match the mesh shape")):
        assert errs[key] is not None and errs[key][0] == "ValueError", key
        assert match in errs[key][1], (key, errs[key])
    assert errs["not_a_mesh"][0] == "TypeError"
    assert got["local"]["exchange"]["ops"] > 0


@pytestmark_shapes
def test_each_rank_fills_only_its_shard(runs, env, shape):
    """An independent PageRank: every fill call covers this rank's
    instances (I / data) of its partitions (P / model), once."""
    data, model = shape
    for r, res in enumerate(runs[shape]):
        f = res["fills"]
        assert "error" not in f, f["error"]
        assert f["local"]["fills"] == [(4 // data, 4 // model)]
        m = r % model
        assert f["local"]["parts"] == (m * (4 // model),
                                       (m + 1) * (4 // model))
    _same_bits(runs[shape][0]["fills"]["values"],
               runs[shape][-1]["fills"]["values"])


# ---------------------------------------------------------------------------
# here, without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,nnz", [
    (("model",), None), (("model",), 10), (("pod", "model"), None),
    (("pod", "model"), 10), (("pod", "model"), 1 << 15),
    (("pod", "model"), 1 << 18), (("data", "model"), 1 << 18)])
def test_recommended_comm_table(axes, nnz):
    """The port's table is the reference's, constants included."""
    fake = object()
    assert t_mesh.recommended_comm(fake, axes, boundary_nnz=nnz) == \
        j_mesh.recommended_comm(fake, axes, boundary_nnz=nnz)
    assert t_mesh.recommended_comm(None) == j_mesh.recommended_comm(None)
    assert (t_mesh.RING_MIN_CUT_BYTES, t_mesh.RING_RS_MIN_CUT_BYTES) == \
        (j_mesh.RING_MIN_CUT_BYTES, j_mesh.RING_RS_MIN_CUT_BYTES)


def test_bind_sync_is_ring_only():
    """``tests/test_comm_backends.py``'s case on the port."""
    r = C.RingExchange(axis_name=("model",), axis_sizes=(4,))
    assert r.bind_sync(("data",)).sync_axes == ("data",)
    assert r.sync_axes == ()
    d = C.DenseAllReduce(axis_name=("model",))
    assert d.bind_sync(("data",)) is d
    h = C.HostGather()
    assert h.bind_sync(("data",)) is h
    jr = j_comm.RingExchange(axis_name=("model",), axis_sizes=(4,))
    assert jr.bind_sync(("data",)).sync_axes == r.bind_sync(
        ("data",)).sync_axes


def test_init_mesh_is_explicit_about_backend_and_device():
    """nccl needs the card, an unknown backend is refused, cuda without a
    card raises: nothing falls back to gloo or the CPU."""
    with pytest.raises(ValueError, match="needs CUDA"):
        t_mesh.init_mesh(1, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        t_mesh.init_mesh(1, 1, backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_mesh.init_mesh(1, 1, device="cuda")
    with pytest.raises(TypeError, match="DeviceMesh"):
        C.make_comm("dense", mesh=object())
    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert t_mesh.mesh_dp_axes(fake) == ("pod", "data")


def test_mesh_graph_cli_under_torchrun():
    """``python -m repro_torch.launch.mesh_graph`` under ``torchrun`` on a
    (1, 2) gloo mesh on the CPU: the plan's placement, and ``--check``'s
    parity with the stacked session."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.mesh_graph",
         "--data", "1", "--model", "2", "--backend", "gloo", "--device",
         "cpu", "--comm", "ring-rs", "--check"], env=env,
        capture_output=True, text=True, timeout=WAIT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "placement = mesh{'data': 1, 'model': 2}" in r.stdout
    assert "comm      = ring-rs  [override]" in r.stdout
    assert r.stdout.strip().endswith("parity OK")
