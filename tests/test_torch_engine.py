"""The port's stacked TemporalEngine against the JAX package's, end to end:
each package generates, partitions, blocks and stages TR_TINY with its own
code, then runs the same programs.  Min-plus: values, final, supersteps
and local sweeps bitwise; ``merged`` within rtol 1e-6 (jnp.mean and
torch.mean sum in another order).  PageRank: rtol 1e-5, atol 1e-7."""
import dataclasses
import doctest

import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.configs.goffish_tr import TR_TINY as J_TR_TINY
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition
import repro_torch.core.engine as T
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core.algorithms.pagerank import edge_weights_for_instances
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph

PATTERNS = ("sequential", "independent", "eventually")
PORT_MODES = ("off", "spmv", "fused")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slice_env():
    """Both packages' pipelines, each run by its own code."""
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
    I = len(col)
    lat = np.stack([col.edge_values(i, "latency") for i in range(I)])
    act = np.stack([col.edge_values(i, "active") for i in range(I)])
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)
    # a monotone-improving collection, where warm starts are exact
    mono = np.minimum.accumulate(lat, axis=0)
    return dict(bg=bg, jbg=jbg, lat=lat, mono=mono, prw=prw,
                V=t.num_vertices, ref_cache={})


def _programs(name, V):
    if name == "sssp":
        return (T.min_plus_program("sssp", init=T.source_init(0)),
                J.min_plus_program("sssp", init=J.source_init(0)))
    return (T.pagerank_program(V, iters=8), J.pagerank_program(V, iters=8))


def _reference(env, name, pattern, layout, warm):
    key = (name, pattern, layout, warm)
    if key not in env["ref_cache"]:
        _, jprog = _programs(name, env["V"])
        w = env["mono"] if name == "sssp" else env["prw"]
        kw = dict(merge="mean") if pattern == "eventually" else {}
        env["ref_cache"][key] = J.TemporalEngine(env["jbg"], layout=layout).run(
            jprog, w, pattern=pattern, warm_start=warm, **kw)
    return env["ref_cache"][key]


def _assert_matches(got, ref, name):
    assert got.pattern == ref.pattern
    assert got.warm_start == ref.warm_start
    assert got.occupancy == ref.occupancy
    for k in ("supersteps", "local_sweeps"):
        assert np.array_equal(got.stats[k], np.asarray(ref.stats[k])), k
    if name == "sssp":
        assert np.array_equal(got.values, ref.values)
        assert np.array_equal(got.final, ref.final)
    else:
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got.final, ref.final, rtol=1e-5,
                                   atol=1e-7)
    if ref.merged is None:
        assert got.merged is None
    else:
        rtol, atol = (1e-6, 0) if name == "sssp" else (1e-5, 1e-7)
        np.testing.assert_allclose(got.merged, ref.merged, rtol=rtol,
                                   atol=atol)
    saved, jsaved = got.supersteps_saved(), ref.supersteps_saved()
    assert (saved is None) == (jsaved is None)
    if saved is not None:
        assert np.array_equal(saved, jsaved)
    assert dataclasses.asdict(got.bsp_stats()) == \
        dataclasses.asdict(ref.bsp_stats())


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_engine_matches_reference(slice_env, name, pattern, layout, warm):
    """3 patterns x 2 layouts x warm on/off, in every port kernel mode."""
    prog, _ = _programs(name, slice_env["V"])
    ref = _reference(slice_env, name, pattern, layout, warm)
    w = slice_env["mono"] if name == "sssp" else slice_env["prw"]
    kw = dict(merge="mean") if pattern == "eventually" else {}
    for mode in PORT_MODES:
        eng = T.TemporalEngine(slice_env["bg"], device="cpu", layout=layout,
                               use_pallas=mode)
        got = eng.run(prog, w, pattern=pattern, warm_start=warm, **kw)
        _assert_matches(got, ref, name)
        assert got.stats["host_syncs"].shape == got.stats["supersteps"].shape


def test_warm_start_saves_supersteps(slice_env):
    """On a monotone-improving collection the warm seed converges to the
    same states in fewer supersteps, as in the reference."""
    prog, _ = _programs("sssp", slice_env["V"])
    eng = T.TemporalEngine(slice_env["bg"], device="cpu", use_pallas="fused")
    cold = eng.run(prog, slice_env["mono"], pattern="independent")
    warm = eng.run(prog, slice_env["mono"], pattern="independent",
                   warm_start=True)
    assert np.array_equal(cold.values, warm.values)
    assert warm.stats["supersteps"].sum() < cold.stats["supersteps"].sum()
    assert warm.supersteps_saved().sum() > 0


def test_pre_staged_tiles_and_sparse(slice_env):
    """tiles=/btiles= (device tensors or host arrays) and sparse= give the
    staged-from-weights result; a pre-staged batch picks its own layout."""
    bg = slice_env["bg"]
    prog, _ = _programs("sssp", slice_env["V"])
    w = slice_env["lat"]
    dense = T.TemporalEngine(bg, device="cpu", use_pallas="spmv")
    ref = dense.run(prog, w, pattern="sequential")
    lt, bt = dense.stage(w, prog.zero_fill)
    host = (bg.fill_local_batch(w, prog.zero_fill),
            bg.fill_boundary_batch(w, prog.zero_fill))
    sp = dense.stage_sparse(w, prog.zero_fill)
    sparse_eng = T.TemporalEngine(bg, device="cpu", layout="sparse")
    for got in (dense.run(prog, pattern="sequential", tiles=lt, btiles=bt),
                dense.run(prog, pattern="sequential", tiles=host[0],
                          btiles=host[1]),
                dense.run(prog, pattern="sequential", sparse=sp),
                sparse_eng.run(prog, pattern="sequential", tiles=lt,
                               btiles=bt)):
        assert np.array_equal(got.values, ref.values)
        assert np.array_equal(got.stats["supersteps"],
                              ref.stats["supersteps"])


def test_run_many_shares_one_upload(slice_env, monkeypatch):
    """run_many over one host-staged batch uploads it once (the 4-slot
    staged-batch cache behind the ``_device_put`` seam) and equals each
    spec run alone."""
    calls = []
    real = T._device_put

    def counting(x, device):
        calls.append(x.shape)
        return real(x, device)

    monkeypatch.setattr(T, "_device_put", counting)
    bg = slice_env["bg"]
    w = slice_env["lat"]
    eng = T.TemporalEngine(bg, device="cpu", use_pallas="fused")
    sssp = T.min_plus_program("sssp", init=T.source_init(0))
    other = T.min_plus_program("sssp7", init=T.source_init(7),
                               subgraph_centric=False)
    specs = [T.RunSpec(sssp, "sequential"),
             T.RunSpec(other, "eventually", merge="mean"),
             T.RunSpec(sssp, "independent", warm_start=True)]
    sp = eng.stage_sparse(w, sssp.zero_fill)
    many = eng.run_many(specs, sparse=sp)
    assert len(calls) == 6  # tiles, btiles, rows, cols, brows, bcols
    again = eng.run_many(specs[:1], sparse=sp)
    assert len(calls) == 6  # cache hit: nothing re-uploaded
    assert np.array_equal(again[0].values, many[0].values)
    for s, got in zip(specs, many):
        alone = eng.run(s.program, w, pattern=s.pattern, merge=s.merge,
                        warm_start=s.warm_start)
        assert np.array_equal(alone.values, got.values)
    host = (bg.fill_local_batch(w), bg.fill_boundary_batch(w))
    eng.run_many(specs[:1], tiles=host[0], btiles=host[1])
    eng.run_many(specs[:1], tiles=host[0], btiles=host[1])
    assert len(calls) == 8
    with pytest.raises(AssertionError, match="zero_fill"):
        eng.run_many([specs[0], T.RunSpec(
            T.pagerank_program(slice_env["V"]), "independent")], w)


def test_not_ported_paths_raise(slice_env):
    bg = slice_env["bg"]
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    w = slice_env["lat"][:1]
    eng = T.TemporalEngine(bg, device="cpu")
    # the query axis is ported: a rank-3 x0 runs, sync and async, and
    # each lane is the scalar run (tests/test_torch_query.py holds it
    # against the reference)
    one = eng.run(prog, w, pattern="sequential")
    for staging in ("sync", "async"):
        two = eng.run(prog, w, pattern="sequential", staging=staging,
                      x0=np.stack([prog.init(bg)] * 2))
        assert two.n_sources == 2
        for q in range(2):
            assert np.array_equal(two.values[q], one.values)
    # mesh placement is ported (tests/test_torch_mesh.py holds it against
    # the reference); a mesh must be a DeviceMesh with named dims
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.TemporalEngine(bg, device="cpu", mesh=object())
    # the cluster runtime is ported (tests/test_torch_cluster.py holds it
    # against the reference): a single-process runtime leaves the engine
    # stacked over every partition, bitwise the plain engine
    from repro_torch.cluster.runtime import ClusterRuntime

    solo = T.TemporalEngine(bg, device="cpu", cluster=ClusterRuntime(0, 1))
    assert solo.parts is None and solo.comm.name == "dense"
    assert np.array_equal(solo.run(prog, w, pattern="sequential").values,
                          one.values)


def test_host_comm_and_label_init_match_reference(slice_env):
    """Label propagation (components seed) through the host comm backend
    equals the reference's dense-comm run, bitwise."""
    bg, jbg = slice_env["bg"], slice_env["jbg"]
    zero_w = np.zeros_like(slice_env["lat"][:2])
    prog = T.min_plus_program("cc", init=T.label_init())
    jprog = J.min_plus_program("cc", init=J.label_init())
    got = T.TemporalEngine(bg, device="cpu", comm="host",
                           use_pallas="fused").run(prog, zero_w,
                                                   pattern="independent")
    ref = J.TemporalEngine(jbg).run(jprog, zero_w, pattern="independent")
    assert np.array_equal(got.values, ref.values)
    assert np.array_equal(got.stats["supersteps"], ref.stats["supersteps"])


def test_docstring_example_reproduces():
    """The TemporalEngine docstring example (and the module's others) run
    as written."""
    res = doctest.testmod(T, optionflags=doctest.ELLIPSIS)
    assert res.attempted >= 15 and res.failed == 0


def test_default_device_is_cuda(slice_env):
    """No device= means the card: without CUDA that raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the error path is for hosts "
                    "without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.TemporalEngine(slice_env["bg"])
