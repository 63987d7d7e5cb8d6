"""The port's host iBSP base against the JAX package's: subgraph discovery,
partition views, bin packing and subgraph topologies equal; ``run_ibsp``
semantics (bulk delivery, halt quiescence, timestep handoff, the Merge,
``workers``); and ``run_host`` of sssp, pagerank, nhop and tracking equal
to the reference's on the same inputs — values bitwise and ``BSPStats``
field by field, with ``workers`` 0 and 4.  Both packages generate TINY
from the same seed with their own code."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import GraphConfig as JGraphConfig
from repro.core import ibsp as j_ibsp
from repro.core import partition as j_partition
from repro.core import subgraph as j_subgraph
from repro.core.algorithms import components as j_components
from repro.core.algorithms import nhop as j_nhop
from repro.core.algorithms import pagerank as j_pagerank
from repro.core.algorithms import sssp as j_sssp
from repro.core.algorithms import tracking as j_tracking
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro_torch.configs.base import GraphConfig
from repro_torch.core import ibsp, partition, subgraph
from repro_torch.core.algorithms import components, nhop, pagerank, sssp, tracking
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection

from tests.conftest import TINY as J_TINY

TINY = GraphConfig(**dataclasses.asdict(J_TINY))
V_ATTRS = ("plate", "outdeg_active")
E_ATTRS = ("latency", "active")


def _pipeline(gen, part, sub, cfg):
    col = gen(cfg, num_plates=6)
    tmpl = col.template
    assign = part.partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
    sg_ids = part.discover_subgraphs(tmpl, assign)
    subs = sub.build_subgraphs(tmpl, assign, sg_ids)
    return col, tmpl, assign, sg_ids, subs


@pytest.fixture(scope="module")
def env():
    port = _pipeline(generate_collection, partition, subgraph, TINY)
    ref = _pipeline(j_generate, j_partition, j_subgraph, J_TINY)
    col, _, _, _, subs = port
    jcol, _, _, _, jsubs = ref
    return dict(
        port=port, ref=ref,
        prov=ibsp.InMemoryProvider(col, subs, vertex_attrs=V_ATTRS,
                                   edge_attrs=E_ATTRS),
        jprov=j_ibsp.InMemoryProvider(jcol, jsubs, vertex_attrs=V_ATTRS,
                                      edge_attrs=E_ATTRS),
    )


def _stats_equal(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# Partition views, subgraphs, bins
# ---------------------------------------------------------------------------

def test_subgraph_ids_and_partitions_match(env):
    _, tmpl, assign, sg_ids, _ = env["port"]
    _, jtmpl, jassign, jsg_ids, _ = env["ref"]
    assert np.array_equal(assign, jassign)
    assert sg_ids.dtype == jsg_ids.dtype and np.array_equal(sg_ids, jsg_ids)
    parts = partition.build_partitions(tmpl, assign, sg_ids)
    jparts = j_partition.build_partitions(jtmpl, jassign, jsg_ids)
    assert len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        for f in dataclasses.fields(jp):
            a, b = getattr(p, f.name), getattr(jp, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        assert p.num_vertices == jp.num_vertices
        assert np.array_equal(p.subgraph_sizes(), jp.subgraph_sizes())


@pytest.mark.parametrize("n_bins", [1, 2, 5, 40])
def test_bin_pack_matches(env, n_bins):
    _, _, _, _, subs = env["port"]
    for pid in sorted({t.pid for t in subs.values()}):
        gids = sorted(g for g, t in subs.items() if t.pid == pid)
        sizes = np.array([subs[g].num_vertices for g in gids], np.int64)
        ids = np.array(gids, np.int64)
        got = partition.bin_pack_subgraphs(sizes, ids, n_bins)
        want = j_partition.bin_pack_subgraphs(sizes, ids, n_bins)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_subgraph_topologies_match(env):
    subs, jsubs = env["port"][4], env["ref"][4]
    assert sorted(subs) == sorted(jsubs)
    for g, jt in jsubs.items():
        t = subs[g]
        for f in dataclasses.fields(jt):
            a, b = getattr(t, f.name), getattr(jt, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        for a, b in zip(t.local_adjacency(), jt.local_adjacency()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert t.remote_by_src() == jt.remote_by_src()
        assert (t.num_vertices, t.num_local_edges) == \
            (jt.num_vertices, jt.num_local_edges)


# ---------------------------------------------------------------------------
# run_ibsp semantics (tests/test_ibsp.py's cases, on the port)
# ---------------------------------------------------------------------------

def test_bulk_message_delivery(env):
    """Messages sent in superstep s are visible exactly at superstep s+1."""
    subs, prov = env["port"][4], env["prov"]
    seen = {}

    def compute(ctx):
        if ctx.superstep == 1:
            for g in subs:
                if g != ctx.subgraph.sgid:
                    ctx.send_to_subgraph(g, ("hello", ctx.subgraph.sgid))
        elif ctx.superstep == 2:
            seen[ctx.subgraph.sgid] = sorted(m[1] for m in ctx.messages)
        ctx.vote_to_halt()

    ibsp.run_ibsp(prov, compute, pattern="independent")
    for g in subs:
        assert sorted(set(seen[g])) == sorted(x for x in subs if x != g)


def test_halt_quiescence(env):
    """A compute that halts immediately runs exactly one superstep per
    timestep."""
    prov = env["prov"]
    calls = []

    def compute(ctx):
        calls.append((ctx.timestep, ctx.superstep))
        ctx.vote_to_halt()

    res = ibsp.run_ibsp(prov, compute, pattern="sequential")
    assert res.stats.supersteps == prov.num_timesteps()
    assert max(s for _, s in calls) == 1


def test_sequential_timestep_handoff(env):
    """SendToNextTimeStep messages arrive at superstep 1 of the next
    timestep; SendToSubgraphInNextTimeStep reaches the named subgraph."""
    subs, prov = env["port"][4], env["prov"]
    first = min(subs)
    got, got_first = {}, {}

    def compute(ctx):
        if ctx.timestep > 0 and ctx.superstep == 1:
            got.setdefault(ctx.timestep, []).extend(
                m for m in ctx.messages if m[0] == "t")
            if ctx.subgraph.sgid == first:
                got_first[ctx.timestep] = [m for m in ctx.messages
                                           if m[0] == "to_first"]
        ctx.send_to_next_timestep(("t", ctx.timestep))
        ctx.send_to_subgraph_in_next_timestep(first, ("to_first",))
        ctx.vote_to_halt()

    res = ibsp.run_ibsp(prov, compute, pattern="sequential")
    for t in range(1, prov.num_timesteps()):
        assert all(m == ("t", t - 1) for m in got[t])
        assert len(got[t]) == len(subs)
        assert len(got_first[t]) == len(subs)
    assert res.stats.timestep_messages == 2 * len(subs) * prov.num_timesteps()


def test_eventually_merge_collects_all(env):
    subs, prov = env["port"][4], env["prov"]

    def compute(ctx):
        ctx.send_message_to_merge((ctx.timestep, ctx.subgraph.sgid))
        ctx.vote_to_halt()

    def merge(mctx):
        mctx.emit(list(mctx.messages))

    res = ibsp.run_ibsp(prov, compute, pattern="eventually", merge=merge,
                        workers=3)
    # timestep order, subgraph order within a timestep, whatever the pool
    assert res.merge_result == [(t, g) for t in range(prov.num_timesteps())
                                for g in sorted(subs)]
    assert res.stats.merge_messages == len(res.merge_result)


def test_unknown_pattern_rejected(env):
    with pytest.raises(ValueError):
        ibsp.run_ibsp(env["prov"], lambda ctx: None, pattern="bulk")


@pytest.mark.parametrize("pattern", ["sequential", "independent"])
def test_message_order_independent_of_workers(env, pattern):
    """Each subgraph's inbox holds the same messages in the same order
    with a thread pool as without one."""
    subs, prov = env["port"][4], env["prov"]

    def run(workers):
        inboxes = {}

        def compute(ctx):
            if ctx.superstep == 1:
                for g in sorted(subs)[:5]:
                    ctx.send_to_subgraph(g, (ctx.subgraph.sgid, ctx.timestep))
            else:
                inboxes[(ctx.timestep, ctx.subgraph.sgid)] = list(ctx.messages)
            ctx.vote_to_halt()

        res = ibsp.run_ibsp(prov, compute, pattern=pattern, workers=workers)
        return inboxes, res.stats

    (a, sa), (b, sb) = run(0), run(6)
    assert a == b
    _stats_equal(sa, sb)


# ---------------------------------------------------------------------------
# run_host against the reference's, values bitwise and BSPStats equal
# ---------------------------------------------------------------------------

def _plate_start(env, plate=2):
    plates = env["port"][0].vertex_values(0, "plate")
    where = np.nonzero(plates == plate)[0]
    return plate, int(where[0]) if len(where) else 0


def _run(env, algo, which, prov, workers):
    mods = {"port": (sssp, pagerank, nhop, tracking),
            "ref": (j_sssp, j_pagerank, j_nhop, j_tracking)}[which]
    s, pr, nh, tr = mods
    V = env["port"][1].num_vertices
    if algo == "sssp":
        out, res = s.run_host(prov, 0, workers=workers)
    elif algo == "pagerank":
        out, res = pr.run_host(prov, V, iters=12, workers=workers)
    elif algo == "nhop":
        out, res = nh.run_host(prov, 0, n_hops=4, workers=workers)
    else:
        plate, start = _plate_start(env)
        out, res = tr.run_host(prov, plate, start, search_depth=5,
                               workers=workers)
    return out, res


def _assert_outputs_equal(algo, got, want):
    if algo == "sssp" or algo == "pagerank":
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k], equal_nan=True), k
    elif algo == "nhop":
        assert np.array_equal(got["composite"], want["composite"])
        assert sorted(got["per_timestep"]) == sorted(want["per_timestep"])
        for t, h in want["per_timestep"].items():
            assert np.array_equal(got["per_timestep"][t], h)
    else:
        assert got == want


ALGOS = ["sssp", "pagerank", "nhop", "tracking"]


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_run_host_matches_reference(env, algo, workers):
    """Port on its own provider (workers 0 / 4) == reference on its
    provider (serial): values bitwise, stats field by field."""
    got, res = _run(env, algo, "port", env["prov"], workers)
    want, jres = _run(env, algo, "ref", env["jprov"], 0)
    _assert_outputs_equal(algo, got, want)
    _stats_equal(res.stats, jres.stats)
    assert len(res.per_timestep_stats) == len(jres.per_timestep_stats)
    for a, b in zip(res.per_timestep_stats, jres.per_timestep_stats):
        _stats_equal(a, b)


@pytest.mark.parametrize("algo", ALGOS)
def test_run_host_on_the_reference_provider(env, algo):
    """The same provider object under both engines: the port's run_host
    over the reference's InMemoryProvider equals the reference's."""
    got, res = _run(env, algo, "port", env["jprov"], 0)
    want, jres = _run(env, algo, "ref", env["jprov"], 0)
    _assert_outputs_equal(algo, got, want)
    _stats_equal(res.stats, jres.stats)


def test_sssp_host_matches_oracle(env):
    """The reference's three-way check, host side: reachability exact,
    distances rtol 1e-6 against Bellman-Ford."""
    col, tmpl, _, _, subs = env["port"]
    w = np.stack([col.edge_values(t, "latency") for t in range(len(col))])
    d_o = sssp.oracle(tmpl.src, tmpl.dst, w, tmpl.num_vertices, 0)
    res_h, _ = sssp.run_host(env["prov"], 0)
    d_h = np.full(tmpl.num_vertices, np.inf)
    for g, dist in res_h.items():
        d_h[subs[g].vertices] = dist
    fin = np.isfinite(d_o)
    assert np.array_equal(np.isfinite(d_h), fin)
    np.testing.assert_allclose(d_h[fin], d_o[fin], rtol=1e-6)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_nhop_and_components_oracles_match(env, t):
    col, tmpl, _, _, _ = env["port"]
    jcol, jtmpl = env["ref"][0], env["ref"][1]
    lat = col.edge_values(t, "latency")
    act = col.edge_values(t, "active")
    assert np.array_equal(lat, jcol.edge_values(t, "latency"))
    for n_hops in (2, 4):
        got = nhop.oracle(tmpl.src, tmpl.dst, lat, tmpl.num_vertices, 0,
                          n_hops=n_hops)
        want = j_nhop.oracle(jtmpl.src, jtmpl.dst, lat, jtmpl.num_vertices,
                             0, n_hops=n_hops)
        assert np.array_equal(got, want)
        assert np.array_equal(nhop.histogram(lat[:50]),
                              j_nhop.histogram(lat[:50]))
    got = components.oracle(tmpl.src, tmpl.dst, act, tmpl.num_vertices)
    want = j_components.oracle(jtmpl.src, jtmpl.dst, act,
                               jtmpl.num_vertices)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_nhop_host_matches_oracle(env):
    col, tmpl, _, _, _ = env["port"]
    want = sum(
        nhop.oracle(tmpl.src, tmpl.dst, col.edge_values(t, "latency"),
                    tmpl.num_vertices, 0, n_hops=4)
        for t in range(len(col)))
    merged, _ = nhop.run_host(env["prov"], 0, n_hops=4)
    assert np.array_equal(merged["composite"], want)
    assert np.array_equal(nhop.DEFAULT_BINS, j_nhop.DEFAULT_BINS)


def test_symmetrized_blocked_matches(env):
    _, tmpl, assign, _, _ = env["port"]
    _, jtmpl, jassign, _, _ = env["ref"]
    bg = build_blocked(tmpl, assign, TINY.block_size)
    jbg = j_build_blocked(jtmpl, jassign, J_TINY.block_size)
    got = components.symmetrized_blocked(bg, tmpl.src, tmpl.dst)
    want = j_components.symmetrized_blocked(jbg, jtmpl.src, jtmpl.dst)
    for f in dataclasses.fields(got):
        if f.name.startswith("_"):
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
