"""The port's query axis (Q source states in one engine pass) against the
JAX package's.

* The graph kernels' plain versions in their Q-lane form against the
  reference's ``jax.vmap`` of its kernels (Pallas in interpret mode):
  min-plus bitwise, plus-mul within 2e-5 (``tests/test_kernels.py:46``),
  votes exactly.
* ``sources_init`` equal to the reference's.
* ``TemporalEngine.run`` with a (Q, P, Vp) ``x0`` under all three
  patterns, dense and sparse, sync and async, cold and warm: values,
  finals, merged, and the (Q, I) supersteps and local sweeps equal to the
  reference's bitwise, and every lane equal to its own single-source run.
* Lanes stopped by ``max_supersteps`` beside lanes that converge.
* The host comm backend under the query axis, against the reference's
  dense comm (its ``HostGather`` cannot take the query axis).
* The session: ``sssp`` and ``nhop`` with a sequence of sources and
  ``tracking``, in memory and from a GoFS store, plans equal to the
  reference's except ``kernel``, outputs equal.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.configs.goffish_tr import TR_TINY as J_TR_TINY
from repro.core.algorithms import tracking as j_tracking
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.core.semiring import PLUS_MUL as J_PLUS_MUL
from repro.gofs import GoFSStore as JGoFSStore
from repro.gopher import GopherSession as JGopherSession
from repro.kernels.semiring_spmm.ops import spmv_blocked as j_spmv
from repro.kernels.semiring_superstep.ops import fused_step as j_fused
import repro_torch.core.engine as T
from repro_torch.configs.base import GraphConfig
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core.algorithms import tracking
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
from repro_torch.gofs import GoFSStore, deploy_collection
from repro_torch.gopher import GopherSession
from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref

from tests.conftest import TINY as J_TINY

SR = {"min_plus": (MIN_PLUS, J_MIN_PLUS), "plus_mul": (PLUS_MUL, J_PLUS_MUL)}
TOL = 2e-5  # tests/test_kernels.py:46
MERGED_RTOL = 1e-6  # jnp.mean and torch.mean sum in another order
PATTERNS = ("sequential", "independent", "eventually")
SOURCES = [0, 5, 17, 100]
TINY = GraphConfig(**dataclasses.asdict(J_TINY))
INF = float(np.inf)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agree(got, want, sr_name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if sr_name == "min_plus":
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# the kernels' plain versions, Q lanes
# --------------------------------------------------------------------------

def _lane_inputs(rng, sr, B, Q, shared, P=3, T_=7, nvb=4, nbb=5):
    """Blocked structure (sorted valid columns, padding last), Q lanes of
    states (some unreached under min-plus) and a vote mask."""
    nvb_in = nbb if shared else nvb
    tiles = np.full((P, T_, B, B), sr.zero, np.float32)
    rows = np.full((P, T_), -1, np.int32)
    cols = np.full((P, T_), -1, np.int32)
    for p in range(P):
        n = T_ if p == 0 else int(rng.integers(0, T_ + 1))
        cols[p, :n] = np.sort(rng.integers(0, nvb, n))
        rows[p, :n] = rng.integers(0, nvb_in, n)
        m = rng.random((n, B, B)) < 0.4
        blk = tiles[p, :n]
        blk[m] = rng.random(int(m.sum()))
    x_in = rng.random((Q, 1 if shared else P, nvb_in, B)).astype(np.float32)
    x = rng.random((Q, P, nvb, B)).astype(np.float32)
    if sr is MIN_PLUS:
        x_in[::2, :, 0] = np.inf  # unreached blocks in every other lane
        x[1::2, 0, 1] = np.inf
    x_ref = x.copy()
    x_ref[:, :, ::2] = rng.random(x_ref[:, :, ::2].shape)
    vmask = rng.random((P, nvb, B)) < 0.9
    return tiles, rows, cols, x_in, x, x_ref, vmask


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_part", "shared"])
@pytest.mark.parametrize("Q", [1, 3, 9])
def test_q_lane_spmv_matches_reference_vmap(B, sr_name, shared, Q):
    """The plain Q-lane SpMV (and the wrapper on CPU tensors) against the
    reference's SpMV vmapped over partitions and then over lanes."""
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(B + 7 * Q + 3 * shared + len(sr_name))
    tiles, rows, cols, x_in, _, _, _ = _lane_inputs(rng, sr, B, Q, shared)
    nvb = 4
    x = x_in.reshape(Q, x_in.shape[1], -1)

    def per_part(t, r, c, xp):
        return j_spmv(t, r, c, xp, jsr, n_out_blocks=nvb, use_pallas=True,
                      interpret=True)

    over_p = jax.vmap(per_part, in_axes=(0, 0, 0, None if shared else 0))
    want = jax.vmap(over_p, in_axes=(None, None, None, 0))(
        jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(x[:, 0] if shared else x))
    t = [torch.from_numpy(a) for a in (tiles, rows, cols, x)]
    got = spmv_blocked_ref(*t, sr, n_out_blocks=nvb)
    assert got.shape == (Q, 3, nvb * B)
    _agree(got.numpy(), np.asarray(want), sr_name)
    # the wrapper takes the same call on the CPU; each lane is the
    # rank-2 call on that lane
    assert torch.equal(spmv_blocked_cuda(*t, sr, n_out_blocks=nvb), got)
    for q in range(Q):
        assert torch.equal(spmv_blocked_ref(*t[:3], t[3][q], sr,
                                            n_out_blocks=nvb), got[q])


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shape", ["sweep", "consume"])
@pytest.mark.parametrize("Q", [1, 3, 9])
def test_q_lane_fused_matches_reference_vmap(B, sr_name, shape, Q):
    """The plain Q-lane fused stage against the reference's fused Pallas
    kernel vmapped over lanes (a grid axis over Q): x_out and the (Q, P,
    1) vote."""
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(2 * B + 5 * Q + len(shape) + len(sr_name))
    tiles, rows, cols, x_in, x, x_ref, vmask = _lane_inputs(
        rng, sr, B, Q, shape == "consume")
    if shape == "sweep":
        x_in = x_ref = x
    mask_f = vmask.astype(np.float32)

    def one(xi, xc, xr):
        return j_fused(jnp.asarray(tiles), jnp.asarray(rows),
                       jnp.asarray(cols), xi, xc, xr, jnp.asarray(mask_f),
                       jsr, use_pallas=True, interpret=True)

    jo, jc = jax.vmap(one)(jnp.asarray(x_in), jnp.asarray(x),
                           jnp.asarray(x_ref))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        tiles, rows, cols, x_in, x, x_ref, vmask)]
    go, gc = fused_step_ref(*t, sr)
    assert go.shape == (Q, 3, 4, B) and gc.shape == (Q, 3, 1)
    _agree(go.numpy(), np.asarray(jo), sr_name)
    assert np.array_equal(gc.numpy(), np.asarray(jc))
    ko, kc = fused_step_cuda(*t, sr)  # the wrapper, on CPU tensors
    assert torch.equal(ko, go) and torch.equal(kc, gc)
    for q in range(Q):  # each lane is the rank-3 call on that lane
        o, c = fused_step_ref(*t[:3], t[3][q], t[4][q], t[5][q], t[6], sr)
        assert torch.equal(o, go[q]) and torch.equal(c, gc[q])


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_env():
    """TR_TINY in both packages, each generated and blocked by its own
    code; a monotone-improving latency collection (warm starts exact)."""
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions,
                                          seed=TR_TINY.seed),
                       TR_TINY.block_size)
    jcol = j_generate(J_TR_TINY)
    jt = jcol.template
    jbg = j_build_blocked(jt, j_partition(jt, J_TR_TINY.num_partitions,
                                          seed=J_TR_TINY.seed),
                          J_TR_TINY.block_size)
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    mono = np.minimum.accumulate(lat, axis=0)
    return dict(bg=bg, jbg=jbg, mono=mono, ref={}, single={})


def test_sources_init_matches_reference(slice_env):
    got = T.sources_init(SOURCES)(slice_env["bg"])
    want = J.sources_init(SOURCES)(slice_env["jbg"])
    assert got.shape == (len(SOURCES),) + slice_env["bg"].global_of.shape
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(T.sources_init(np.asarray(SOURCES))(
        slice_env["bg"]), got)
    for q, s in enumerate(SOURCES):
        assert np.array_equal(got[q], T.source_init(s)(slice_env["bg"]))


def _kw(pattern):
    return dict(merge="mean") if pattern == "eventually" else {}


def _ref_run(env, pattern, warm, **prog_kw):
    key = (pattern, warm, tuple(sorted(prog_kw.items())))
    if key not in env["ref"]:
        prog = J.min_plus_program("sssp", init=J.sources_init(SOURCES),
                                  **prog_kw)
        env["ref"][key] = J.TemporalEngine(env["jbg"]).run(
            prog, env["mono"], pattern=pattern, warm_start=warm,
            **_kw(pattern))
    return env["ref"][key]


def _single_runs(env, pattern, warm, **prog_kw):
    """Each source alone through the port (dense, sync, plain)."""
    key = (pattern, warm, tuple(sorted(prog_kw.items())))
    if key not in env["single"]:
        eng = T.TemporalEngine(env["bg"], device="cpu")
        env["single"][key] = [eng.run(
            T.min_plus_program("sssp", init=T.source_init(s), **prog_kw),
            env["mono"], pattern=pattern, warm_start=warm, **_kw(pattern))
            for s in SOURCES]
    return env["single"][key]


def _same_as_reference(got, ref):
    assert got.n_sources == ref.n_sources == len(SOURCES)
    assert np.array_equal(got.values, ref.values)
    assert np.array_equal(got.final, ref.final)
    for k in ("supersteps", "local_sweeps"):
        assert got.stats[k].shape == np.asarray(ref.stats[k]).shape
        assert np.array_equal(got.stats[k], np.asarray(ref.stats[k])), k
    if ref.merged is None:
        assert got.merged is None
    else:
        np.testing.assert_allclose(got.merged, ref.merged, rtol=MERGED_RTOL)
    saved, jsaved = got.supersteps_saved(), ref.supersteps_saved()
    assert (saved is None) == (jsaved is None)
    if saved is not None:
        assert np.array_equal(saved, jsaved)
    assert dataclasses.asdict(got.bsp_stats()) == \
        dataclasses.asdict(ref.bsp_stats())


def _lanes_equal_single(got, singles):
    for q, one in enumerate(singles):
        assert np.array_equal(got.values[q], one.values), q
        assert np.array_equal(got.final[q], one.final), q
        for k in ("supersteps", "local_sweeps"):
            assert np.array_equal(got.stats[k][q], one.stats[k]), (k, q)
        if one.merged is not None:
            assert np.array_equal(got.merged[q], one.merged,
                                  equal_nan=True), q


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("staging", ["sync", "async"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_engine_query_axis_matches_reference(slice_env, pattern, layout,
                                             staging, warm):
    """Rank-3 x0 in both port kernel modes against the reference's run
    and against each source's own run."""
    ref = _ref_run(slice_env, pattern, warm)
    singles = _single_runs(slice_env, pattern, warm)
    prog = T.min_plus_program("sssp", init=T.sources_init(SOURCES))
    for mode in ("spmv", "fused"):
        eng = T.TemporalEngine(slice_env["bg"], device="cpu", layout=layout,
                               staging=staging, use_pallas=mode,
                               chunk_instances=2)
        got = eng.run(prog, slice_env["mono"], pattern=pattern,
                      warm_start=warm, **_kw(pattern))
        _same_as_reference(got, ref)
        _lanes_equal_single(got, singles)
        # one host read per sweep or superstep serves every lane: at
        # least the slowest lane's reads, fewer than all lanes' together
        syncs = np.stack([one.stats["host_syncs"] for one in singles])
        assert got.stats["host_syncs"].shape == syncs.shape[1:]
        assert np.all(got.stats["host_syncs"] >= syncs.max(0))
        assert got.stats["host_syncs"].sum() < syncs.sum()


@pytest.mark.parametrize("subgraph_centric", [True, False],
                         ids=["subgraph", "vertex"])
def test_lanes_stopped_by_max_supersteps(slice_env, subgraph_centric):
    """A cap that stops some lanes while others converge: the stopped
    lanes keep their state bitwise (another superstep would still change
    them), as the reference's vmapped loop keeps them."""
    free = _single_runs(slice_env, "sequential", False,
                        subgraph_centric=subgraph_centric)
    # a cap at the lowest count a lane needs: lanes and instances that
    # converge within it, and others that it stops
    free_ss = np.stack([one.stats["supersteps"] for one in free])
    cap = int(free_ss.min())
    assert (free_ss > cap + 1).any()
    kw = dict(max_supersteps=cap, subgraph_centric=subgraph_centric)
    ref = _ref_run(slice_env, "sequential", False, **kw)
    singles = _single_runs(slice_env, "sequential", False, **kw)
    capped = [q for q in range(len(SOURCES))
              if not np.array_equal(singles[q].values, free[q].values)]
    assert capped  # a cap that changed some lane's result
    prog = T.min_plus_program("sssp", init=T.sources_init(SOURCES), **kw)
    for mode in ("spmv", "fused"):
        got = T.TemporalEngine(slice_env["bg"], device="cpu",
                               use_pallas=mode).run(
            prog, slice_env["mono"], pattern="sequential")
        _same_as_reference(got, ref)
        _lanes_equal_single(got, singles)


@pytest.mark.parametrize("mode", ["spmv", "fused"])
def test_host_comm_matches_reference_dense_comm(slice_env, mode):
    """The host comm backend folds every lane's (P, NB) buffer on the
    host; held against the reference's dense comm (ROADMAP §3)."""
    ref = _ref_run(slice_env, "sequential", False)
    prog = T.min_plus_program("sssp", init=T.sources_init(SOURCES))
    got = T.TemporalEngine(slice_env["bg"], device="cpu", comm="host",
                           use_pallas=mode).run(
        prog, slice_env["mono"], pattern="sequential")
    _same_as_reference(got, ref)


def test_one_source_in_a_sequence_is_a_lane(slice_env):
    """Q = 1 on the query axis: a (1, P, Vp) x0 gives (1, I, V) values
    equal to the scalar run."""
    prog = T.min_plus_program("sssp", init=T.sources_init([SOURCES[1]]))
    got = T.TemporalEngine(slice_env["bg"], device="cpu",
                           use_pallas="fused").run(
        prog, slice_env["mono"], pattern="sequential")
    one = _single_runs(slice_env, "sequential", False)[1]
    assert got.n_sources == 1 and got.values.shape == (1,) + one.values.shape
    _lanes_equal_single(got, [one])


# --------------------------------------------------------------------------
# the session
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sess_env(tiny_collection, tmp_path_factory):
    """TINY (6 plates) in both packages and one deployment both stores
    open."""
    col = generate_collection(TINY, num_plates=6)
    jcol = tiny_collection
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(
        tmpl, TINY.num_partitions, seed=TINY.seed), TINY.block_size)
    jbg = j_build_blocked(jcol.template, j_partition(
        jcol.template, J_TINY.num_partitions, seed=J_TINY.seed),
        J_TINY.block_size)
    I = len(col)
    w = np.stack([col.edge_values(t, "latency") for t in range(I)])
    plates = np.stack([col.vertex_values(t, "plate") for t in range(I)])
    root = str(tmp_path_factory.mktemp("query_gofs"))
    deploy_collection(col, TINY, root, sparse_absent={"latency": INF})
    return dict(bg=bg, jbg=jbg, w=w, plates=plates, root=root)


def _sessions(env, kind):
    if kind == "store":
        return (GopherSession(GoFSStore(env["root"]), device="cpu"),
                JGopherSession(JGoFSStore(env["root"])))
    kw = dict(weights={"latency": env["w"]},
              vertex_attrs={"plate": env["plates"]})
    return (GopherSession.from_blocked(env["bg"], device="cpu", **kw),
            JGopherSession.from_blocked(env["jbg"], **kw))


def _same_plan(p, j):
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if f.name == "kernel":
            assert a.value == b.value == "off", (a, b)
        elif hasattr(b, "reason"):  # a PlanChoice of either package
            assert (a.value, a.source, a.reason) == \
                (b.value, b.source, b.reason), f.name
        else:
            assert a == b, f.name
    for a, b in zip(p.explain().splitlines(), j.explain().splitlines()):
        if not a.lstrip().startswith("kernel"):
            assert a == b


def _plate_and_start(plates):
    """A plate seen in several timesteps, and its first sighting."""
    ids, counts = np.unique(plates[plates >= 0], return_counts=True)
    plate = int(ids[np.argmax(counts)])
    t, v = np.argwhere(plates == plate)[0]
    return plate, int(v)


@pytest.mark.parametrize("kind", ["memory", "store"])
def test_session_query_axis_matches_reference(sess_env, kind):
    """``sssp`` with four sources, ``nhop`` with three and ``tracking``:
    plans equal the reference's except ``kernel``; outputs and engine
    results equal; every sssp lane equals its scalar-source run."""
    sess, jsess = _sessions(sess_env, kind)
    srcs = [0, 7, 42, 299]
    plate, start = _plate_and_start(sess_env["plates"])
    asks = [("sssp", dict(source=srcs)),
            ("nhop", dict(source=srcs[:3], n_hops=3)),
            ("tracking", dict(plate=plate, initial_vertex=start,
                              search_depth=3))]
    for name, kw in asks:
        plan, jplan = sess.plan(name, **kw), jsess.plan(name, **kw)
        _same_plan(plan, jplan)
        got, want = sess.run(plan), jsess.run(jplan)
        assert set(got.output) == set(want.output)
        for k, v in got.output.items():
            if k == "trace":
                assert v == [tuple(map(int, e)) for e in want.output[k]]
            else:
                assert np.array_equal(v, np.asarray(want.output[k])), k
        if want.engine is not None:
            assert got.engine.n_sources == want.engine.n_sources
            assert np.array_equal(got.engine.values, want.engine.values)
            for k in ("supersteps", "local_sweeps"):
                assert np.array_equal(got.engine.stats[k],
                                      np.asarray(want.engine.stats[k]))
    final = sess.run(sess.plan("sssp", source=srcs)).output["final"]
    assert final.shape[0] == len(srcs)
    for q, s in enumerate(srcs):
        assert np.array_equal(
            final[q], sess.run(sess.plan("sssp", source=s)).output["final"])
    hists = sess.run(sess.plan("nhop", source=srcs[:3], n_hops=3)).output
    for q, s in enumerate(srcs[:3]):
        one = sess.run(sess.plan("nhop", source=s, n_hops=3)).output
        assert np.array_equal(hists["histograms"][q], one["histograms"])
        assert np.array_equal(hists["composite"][q], one["composite"])


def test_tracking_trace_equals_host_ibsp(sess_env):
    """The engine's tracking from a store equals the host iBSP
    ``tracking.run_host`` on the same store, and the deprecated
    ``run_blocked`` wrapper (which warns) equals the session."""
    plates = sess_env["plates"]
    plate, start = _plate_and_start(plates)
    store = GoFSStore(sess_env["root"], vertex_projection=("plate",),
                      edge_projection=())
    host, _ = tracking.run_host(store, plate, start, search_depth=3)
    sess = GopherSession(GoFSStore(sess_env["root"]), device="cpu")
    got = sess.run(sess.plan("tracking", plate=plate, initial_vertex=start,
                             search_depth=3)).output["trace"]
    assert got == host and len(got) > 1
    jstore = JGoFSStore(sess_env["root"], vertex_projection=("plate",),
                        edge_projection=())
    assert host == j_tracking.run_host(jstore, plate, start,
                                       search_depth=3)[0]
    with pytest.warns(DeprecationWarning):
        legacy = tracking.run_blocked(sess_env["bg"], plates, plate, start,
                                      search_depth=3, device="cpu")
    assert legacy == got
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert legacy == j_tracking.run_blocked(
            sess_env["jbg"], plates, plate, start, search_depth=3)
