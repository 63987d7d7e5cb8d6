"""The port's BSP superstep drivers against the JAX package's, on identical
``DeviceGraph`` inputs, in every kernel mode (the reference's Pallas
kernels in interpret mode; the port's kernel wrappers run their plain
versions on the CPU).  Min-plus: ``x``, supersteps and local sweeps
bitwise.  Plus-mul: rtol 1e-5, atol 1e-7 (the segment sums associate
differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as j_blocked
from repro.core import superstep as j_superstep
from repro.core.generator import generate_collection as j_generate
from repro.configs.base import GraphConfig as JGraphConfig
from repro_torch.configs.base import GraphConfig
from repro_torch.core import blocked, superstep
from repro_torch.core.algorithms.pagerank import edge_weights_for_instances
from repro_torch.core.comm import HostGather
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import INF, MIN_PLUS, PLUS_MUL

SPEC = dict(name="tiny", num_vertices=300, avg_degree=3.0, num_instances=2,
            num_partitions=3, block_size=32, seed=11)
MODES = {"off": False, "spmv": ("spmv", True), "fused": ("fused", True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    cfg = GraphConfig(**SPEC)
    col = generate_collection(cfg)
    t = col.template
    assign = partition_graph(t, cfg.num_partitions, seed=cfg.seed)
    bg = blocked.build_blocked(t, assign, cfg.block_size)
    jcol = j_generate(JGraphConfig(**SPEC))
    jbg = j_blocked.build_blocked(jcol.template, assign, cfg.block_size)
    lat = col.edge_values(0, "latency")
    act = np.stack([col.edge_values(0, "active")])
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)[0]

    def pair(w, zero):
        lv, bv = bg.fill_local(w, zero), bg.fill_boundary(w, zero)
        return (superstep.device_graph(bg, lv, bv, device="cpu"),
                j_superstep.device_graph(jbg, lv, bv))

    x0 = bg.scatter_vertex(np.full(t.num_vertices, INF, np.float32), INF)
    x0[bg.part_of[0], bg.local_of[0]] = 0.0
    return dict(bg=bg, sssp=pair(lat, INF), pr=pair(prw, 0.0), x0=x0,
                V=t.num_vertices)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("subgraph_centric", [True, False],
                         ids=["subgraph", "vertex"])
def test_bsp_fixpoint_bitwise(graphs, mode, subgraph_centric):
    dg, jdg = graphs["sssp"]
    x0 = graphs["x0"]
    x, st = superstep.bsp_fixpoint(torch.from_numpy(x0), dg, MIN_PLUS,
                                   subgraph_centric=subgraph_centric,
                                   use_pallas=mode)
    jx, jst = j_superstep.bsp_fixpoint(
        jnp.asarray(x0), jdg, j_superstep.MIN_PLUS,
        subgraph_centric=subgraph_centric, use_pallas=MODES[mode])
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert st["supersteps"] == int(jst["supersteps"])
    assert st["local_sweeps"] == int(jst["local_sweeps"])
    assert st["supersteps"] > 1  # the graph needs real exchanges
    # one vote read per superstep and per non-final sweep
    if not subgraph_centric:
        assert st["host_syncs"] == st["supersteps"] - (
            st["supersteps"] == 64)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pagerank_run_matches(graphs, mode):
    dg, jdg = graphs["pr"]
    r, it = superstep.pagerank_run(dg, num_vertices=graphs["V"], iters=12,
                                   use_pallas=mode)
    jr, jit_ = j_superstep.pagerank_run(jdg, num_vertices=graphs["V"],
                                        iters=12, use_pallas=MODES[mode])
    assert it == int(jit_) == 12
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-7)


def test_pagerank_tolerance_stops_early(graphs):
    dg, jdg = graphs["pr"]
    r, it = superstep.pagerank_run(dg, num_vertices=graphs["V"], iters=200,
                                   tol=1e-6)
    jr, jit_ = j_superstep.pagerank_run(jdg, num_vertices=graphs["V"],
                                        iters=200, tol=1e-6)
    assert it == int(jit_) < 200
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-7)


def test_host_gather_matches_dense(graphs):
    dg, _ = graphs["sssp"]
    x0 = torch.from_numpy(graphs["x0"])
    a, sa = superstep.bsp_fixpoint(x0, dg, use_pallas="fused")
    b, sb = superstep.bsp_fixpoint(x0, dg, use_pallas="fused",
                                   comm=HostGather())
    assert torch.equal(a, b) and sa == sb


def test_max_supersteps_cap(graphs):
    """The cap stops the loop as the reference's while_loop does, and the
    last vote is not read."""
    dg, jdg = graphs["sssp"]
    x0 = graphs["x0"]
    x, st = superstep.bsp_fixpoint(torch.from_numpy(x0), dg,
                                   max_supersteps=2, max_local_sweeps=3)
    jx, jst = j_superstep.bsp_fixpoint(jnp.asarray(x0), jdg,
                                       max_supersteps=2, max_local_sweeps=3)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert st["supersteps"] == int(jst["supersteps"]) == 2
    assert st["local_sweeps"] == int(jst["local_sweeps"])
    assert st["host_syncs"] <= 1 + 2 * 2


@pytest.mark.parametrize("mode", ["spmv", "fused"])
def test_step_primitives_match(graphs, mode):
    """One sweep, one publish, one consume: each equals the reference."""
    dg, jdg = graphs["sssp"]
    x = torch.from_numpy(graphs["x0"])
    jx = jnp.asarray(graphs["x0"])
    jm = MODES[mode]
    x1 = superstep._local_sweep(x, dg, MIN_PLUS, mode)
    jx1 = j_superstep._local_sweep(jx, jdg, j_superstep.MIN_PLUS, jm)
    assert np.array_equal(x1.numpy(), np.asarray(jx1))
    for sr, jsr in ((MIN_PLUS, j_superstep.MIN_PLUS),
                    (PLUS_MUL, j_superstep.PLUS_MUL)):
        b = superstep._publish(x1, dg, sr, superstep.DenseAllReduce())
        jb = j_superstep._publish(jx1, jdg, jsr,
                                  j_superstep.DenseAllReduce())
        assert np.array_equal(b.numpy(), np.asarray(jb))
    b = superstep._publish(x1, dg, MIN_PLUS, superstep.DenseAllReduce())
    x2 = superstep._consume(x1, b, dg, MIN_PLUS, mode)
    jx2 = j_superstep._consume(jx1, jnp.asarray(b.numpy()), jdg,
                               j_superstep.MIN_PLUS, jm)
    assert np.array_equal(x2.numpy(), np.asarray(jx2))


def test_kernel_mode_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert superstep.kernel_mode(None, cpu) == "off"
    assert superstep.kernel_mode(None, cuda) == "spmv"
    assert superstep.kernel_mode(True, cpu) == "spmv"
    assert superstep.kernel_mode(False, cpu) == "off"
    assert superstep.kernel_mode("fused", cuda) == "fused"
    with pytest.raises(ValueError, match="test oracles"):
        superstep.kernel_mode("off", cuda)
    with pytest.raises(ValueError, match="unknown kernel mode"):
        superstep.kernel_mode("pallas", cpu)
    assert superstep.KERNEL_MODES == j_superstep.KERNEL_MODES


def test_device_graph_needs_cuda_unless_cpu(graphs):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the error path is for hosts "
                    "without it")
    bg = graphs["bg"]
    lv = np.zeros((bg.n_parts, bg.t_max, bg.block_size, bg.block_size),
                  np.float32)
    bv = np.zeros((bg.n_parts, bg.tb_max, bg.block_size, bg.block_size),
                  np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        superstep.device_graph(bg, lv, bv)
    dg = superstep.device_graph(bg, lv, bv, device="cpu")
    assert dg.device.type == "cpu" and dg.rows.dtype == torch.int32
