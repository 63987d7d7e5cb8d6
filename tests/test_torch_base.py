"""The port's numpy base, semirings and stacked comm against the JAX
package: same seed -> same collection, partition, blocked structure and
staged tiles, bitwise; and ``import repro_torch`` loads no JAX."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.goffish_tr as j_cfg
from repro.configs.base import GraphConfig as JGraphConfig
from repro.core import blocked as j_blocked
from repro.core import comm as j_comm
from repro.core.algorithms import pagerank as j_pagerank
from repro.core.algorithms import sssp as j_sssp
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import edge_cut as j_edge_cut
from repro.core.partition import partition_graph as j_partition
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.core.semiring import PLUS_MUL as J_PLUS_MUL
from repro_torch.configs import get_graph_config
from repro_torch.configs.base import GraphConfig
from repro_torch.core import blocked, comm
from repro_torch.core.algorithms import pagerank, sssp
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import edge_cut, partition_graph
from repro_torch.core.semiring import INF, MIN_PLUS, PLUS_MUL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(name="tiny", num_vertices=300, avg_degree=3.0, num_instances=3,
            num_partitions=3, block_size=32, instances_per_slice=2,
            bins_per_partition=2, cache_slots=4, seed=11)
CONFIGS = {"tr_tiny": "tiny", "conftest_tiny": TINY}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(key):
    spec = CONFIGS[key]
    if isinstance(spec, str):
        return get_graph_config(spec), getattr(j_cfg, "TR_TINY")
    return GraphConfig(**spec), JGraphConfig(**spec)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    """(port cfg, collection, assign) and the reference's, same config."""
    cfg, jcfg = _configs(request.param)
    col, jcol = generate_collection(cfg), j_generate(jcfg)
    a = partition_graph(col.template, cfg.num_partitions, seed=cfg.seed)
    ja = j_partition(jcol.template, jcfg.num_partitions, seed=jcfg.seed)
    return (cfg, col, a), (jcfg, jcol, ja)


def test_configs_match_reference():
    for name in ("full", "small", "tiny"):
        ours = dataclasses.asdict(get_graph_config(name))
        ref = dataclasses.asdict({"full": j_cfg.TR_FULL,
                                  "small": j_cfg.TR_SMALL,
                                  "tiny": j_cfg.TR_TINY}[name])
        assert ours == ref


def test_generate_collection_bitwise(both):
    (_, col, _), (_, jcol, _) = both
    t, jt = col.template, jcol.template
    assert t.num_vertices == jt.num_vertices
    assert np.array_equal(t.src, jt.src) and np.array_equal(t.dst, jt.dst)
    assert [a.name for a in t.edge_attrs] == [a.name for a in jt.edge_attrs]
    assert len(col) == len(jcol)
    for g, jg in zip(col.instances, jcol.instances):
        assert g.timestamp == jg.timestamp and g.duration == jg.duration
        for vals, jvals in ((g.vertex_values, jg.vertex_values),
                            (g.edge_values, jg.edge_values)):
            assert vals.keys() == jvals.keys()
            for k in vals:
                assert vals[k].dtype == jvals[k].dtype
                assert np.array_equal(vals[k], jvals[k]), k


def test_partition_and_edge_cut_match(both):
    (_, col, a), (_, jcol, ja) = both
    assert a.dtype == ja.dtype and np.array_equal(a, ja)
    assert edge_cut(col.template, a) == j_edge_cut(jcol.template, ja)


def _fields(bg):
    return {f.name: getattr(bg, f.name) for f in dataclasses.fields(bg)
            if not f.name.startswith("_")}


@pytest.mark.parametrize("block_size", [8, 32])
def test_build_blocked_bitwise(both, block_size):
    (_, col, a), (_, jcol, ja) = both
    bg = blocked.build_blocked(col.template, a, block_size)
    jbg = j_blocked.build_blocked(jcol.template, ja, block_size)
    ours, ref = _fields(bg), _fields(jbg)
    assert ours.keys() == ref.keys()
    for k in ours:
        if isinstance(ref[k], np.ndarray):
            assert ours[k].dtype == ref[k].dtype, k
            assert np.array_equal(ours[k], ref[k]), k
        else:
            assert ours[k] == ref[k], k


@pytest.mark.parametrize("zero", [INF, 0.0], ids=["min_plus", "plus_mul"])
def test_staging_bitwise(both, zero):
    """Dense batched fills, single-instance fills and the sparse packed
    batch agree with the reference bitwise, for both fill values."""
    (cfg, col, a), (jcfg, jcol, ja) = both
    bg = blocked.build_blocked(col.template, a, cfg.block_size)
    jbg = j_blocked.build_blocked(jcol.template, ja, jcfg.block_size)
    w = np.stack([col.edge_values(t, "latency") for t in range(len(col))])
    if zero == 0.0:
        act = np.stack([col.edge_values(t, "active") for t in range(len(col))])
        w = pagerank.edge_weights_for_instances(col.template.src, act,
                                                col.template.num_vertices)
    for fn in ("fill_local_batch", "fill_boundary_batch"):
        assert np.array_equal(getattr(bg, fn)(w, zero),
                              getattr(jbg, fn)(w, zero)), fn
    for fn in ("fill_local", "fill_boundary"):
        assert np.array_equal(getattr(bg, fn)(w[0], zero),
                              getattr(jbg, fn)(w[0], zero)), fn
    sp, jsp = bg.stage_sparse(w, zero), jbg.stage_sparse(w, zero)
    for f in dataclasses.fields(sp):
        v, jv = getattr(sp, f.name), getattr(jsp, f.name)
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, jv), f.name
        else:
            assert v == jv, f.name
    assert sp.occupancy() == jsp.occupancy()
    assert sp.staged_bytes() == jsp.staged_bytes()


def test_vertex_io_and_from_arrays_round_trip(both):
    (cfg, col, a), (jcfg, jcol, ja) = both
    jbg = j_blocked.build_blocked(jcol.template, ja, jcfg.block_size)
    bg = blocked.BlockedGraph.from_arrays(vars(jbg))
    assert isinstance(bg, blocked.BlockedGraph)
    again = blocked.BlockedGraph.from_arrays(vars(bg))
    for k, v in _fields(again).items():
        ref = getattr(jbg, k)
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, ref) and v is not ref, k
        else:
            assert v == ref, k
    x = np.arange(col.template.num_vertices, dtype=np.float32)
    padded = bg.scatter_vertex(x, INF)
    assert np.array_equal(padded, jbg.scatter_vertex(x, INF))
    assert np.array_equal(bg.gather_vertex(padded), x)
    w = col.edge_values(0, "latency")[None]
    assert np.array_equal(bg.fill_boundary_batch(w), jbg.fill_boundary_batch(w))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 8, 9, 1000])
def test_pow2_bucket(n):
    assert blocked.pow2_bucket(n) == j_blocked.pow2_bucket(n)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_segment_reduce_empty_segments(sr_name):
    """Empty segments hold the semiring zero (+inf / 0), like
    jax.ops.segment_min / segment_sum."""
    sr, jsr = {"min_plus": (MIN_PLUS, J_MIN_PLUS),
               "plus_mul": (PLUS_MUL, J_PLUS_MUL)}[sr_name]
    rng = np.random.default_rng(0)
    vals = rng.random((6, 4)).astype(np.float32)
    seg = np.array([0, 0, 2, 5, 5, 5], np.int32)
    got = sr.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), 7)
    want = jsr.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 7)
    assert torch.all(got[[1, 3, 4, 6]] == sr.zero)
    if sr_name == "min_plus":
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_scatter_add_accumulates(sr_name):
    """Duplicate indices combine with the semiring add; a zero-valued
    padding entry on a real slot leaves it unchanged (the publish path)."""
    sr, jsr = {"min_plus": (MIN_PLUS, J_MIN_PLUS),
               "plus_mul": (PLUS_MUL, J_PLUS_MUL)}[sr_name]
    idx = np.array([0, 2, 0, 2, 0], np.int32)
    vals = np.array([3.0, 1.0, 2.0, 5.0, sr.zero], np.float32)
    y = np.full(4, sr.zero, np.float32)
    got = sr.scatter_add(torch.from_numpy(y), torch.from_numpy(idx),
                         torch.from_numpy(vals))
    want = jsr.scatter_add(jnp.asarray(y), jnp.asarray(idx),
                           jnp.asarray(vals))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["dense", "ring", "ring-rs", "host"])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_comm_fold_matches_reference(backend, sr_name):
    """Every stacked backend folds 0..P-1 left to right: bitwise equal to
    the reference's stacked fold for BOTH semirings."""
    sr, jsr = {"min_plus": (MIN_PLUS, J_MIN_PLUS),
               "plus_mul": (PLUS_MUL, J_PLUS_MUL)}[sr_name]
    rng = np.random.default_rng(1)
    buf = rng.random((5, 64)).astype(np.float32) * 1e3
    buf[rng.random(buf.shape) < 0.3] = sr.zero
    got = comm.make_comm(backend).combine_boundary(torch.from_numpy(buf), sr)
    want = j_comm.make_comm("dense").combine_boundary(jnp.asarray(buf), jsr)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert comm.make_comm(backend).name == j_comm.make_comm(backend).name


def test_make_comm_rejects_mesh_and_unknown():
    # mesh placement is ported (tests/test_torch_mesh.py holds it against
    # the reference); a mesh must be a DeviceMesh with named dims
    with pytest.raises(TypeError, match="DeviceMesh"):
        comm.make_comm("dense", mesh=object())
    with pytest.raises(ValueError, match="unknown comm backend"):
        comm.make_comm("nope")


def test_algorithm_numpy_parts_match(both):
    (_, col, _), _ = both
    t = col.template
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    assert np.array_equal(
        pagerank.edge_weights_for_instances(t.src, act, t.num_vertices),
        j_pagerank.edge_weights_for_instances(t.src, act, t.num_vertices))
    assert np.array_equal(
        pagerank.edge_weights_for_instance(t.src, act[0], t.num_vertices),
        j_pagerank.edge_weights_for_instance(t.src, act[0], t.num_vertices))
    assert np.array_equal(
        pagerank.oracle(t.src, t.dst, act[0], t.num_vertices, iters=5),
        j_pagerank.oracle(t.src, t.dst, act[0], t.num_vertices, iters=5))
    assert np.array_equal(
        sssp.oracle(t.src, t.dst, lat, t.num_vertices, 0),
        j_sssp.oracle(t.src, t.dst, lat, t.num_vertices, 0))


def test_import_loads_no_jax():
    """``import repro_torch`` (and its modules) loads neither jax nor any
    module of the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.engine, "
        "repro_torch.core.generator, repro_torch.core.partition, "
        "repro_torch.core.algorithms, repro_torch.configs, "
        "repro_torch.kernels.semiring_spmm, "
        "repro_torch.kernels.semiring_superstep, "
        "repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.decode_attention, repro_torch.models, "
        "repro_torch.dist.sharding, repro_torch.train.serve_step, "
        "repro_torch.launch.serve, repro_torch.gofs, "
        "repro_torch.gofs.layout, repro_torch.gofs.store, "
        "repro_torch.core.subgraph, repro_torch.core.ibsp, "
        "repro_torch.gopher.service, repro_torch.launch.run_graph, "
        "repro_torch.launch.serve_graph, repro_torch.launch.tail_graph, "
        "repro_torch.cluster, repro_torch.cluster.runtime, "
        "repro_torch.cluster.gather, repro_torch.cluster.staging, "
        "repro_torch.cluster.checkpoint, repro_torch.train.checkpoint, "
        "repro_torch.launch.cluster_graph, repro_torch.launch.mesh, "
        "repro_torch.launch.mesh_graph, "
        "repro_torch.core.temporal, repro_torch.core.comm, "
        "repro_torch.examples.quickstart, repro_torch.examples.temporal_sssp, "
        "repro_torch.examples.vehicle_tracking, "
        "repro_torch.examples.serve_lm\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_port_file_imports_the_reference():
    """No source file of the port names jax or the JAX package."""
    root = os.path.join(REPO, "src", "repro_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                            " jax" in s or "jaxlib" in s
                            or s.startswith(("from repro.", "import repro."))
                            or s in ("import repro", "from repro import")):
                        offenders.append((path, s))
    assert not offenders, offenders
