"""The port's GoFS against the JAX package's.

* Cross-package round trips, both directions: a deployment written by
  either package (plain, and with ``sparse_absent``) is opened by both
  packages' ``GoFSStore``; every instance, topology, attribute matrix,
  tile map, occupancy, bucket pair, delta summary and ``load_blocked``
  batch (dense, sparse, delta) is equal bitwise, and so are the read
  counts and bytes under the same projections and cache slots.
* Two deployments of one collection, one by each package, hold the same
  file names, equal arrays in every npz slice, and equal JSON.
* The reference's own GoFS cases (``tests/test_gofs.py``) and the slice
  cache's stress cases (``tests/test_cache_stress.py``), on the port.
* The slice as a whole: the quickstart's steps 1-3 and 5 on the port
  (``device="cpu"``) against the reference; SSSP from ``load_blocked``
  bitwise, PageRank from the store within 2e-5.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.core.algorithms import pagerank as j_pagerank
from repro.core.algorithms import sssp as j_sssp
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition_graph
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
import repro_torch.core.engine as T
from repro_torch.configs.base import GraphConfig
from repro_torch.core.algorithms import pagerank, sssp
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.ibsp import InMemoryProvider
from repro_torch.core.partition import discover_subgraphs, partition_graph
from repro_torch.core.subgraph import build_subgraphs
from repro_torch.gofs import GoFSStore, SliceCache, deploy_collection
from repro_torch.gofs.cache import _value_nbytes
from repro_torch.gofs.layout import append_instances
from repro_torch.gofs.slices import read_array_slice, read_json_slice

from tests.conftest import TINY as J_TINY
from tests.conftest import given, hyp_st as st, settings

TINY = GraphConfig(**dataclasses.asdict(J_TINY))
INF = float(np.inf)
# PageRank: rtol 2e-5 (tests/test_kernels.py:46); the absolute part stays
# far below the ranks (about 1/V), as in tests/test_torch_engine.py
PR_TOL, PR_ATOL = 2e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def col():
    return generate_collection(TINY, num_plates=6)


@pytest.fixture(scope="module")
def blocked(col):
    """The port's and the reference's BlockedGraph of TINY."""
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(tmpl, TINY.num_partitions,
                                             seed=TINY.seed), TINY.block_size)
    jt = j_generate(J_TINY, num_plates=6).template
    jbg = j_build_blocked(jt, j_partition_graph(jt, J_TINY.num_partitions,
                                                seed=J_TINY.seed),
                          J_TINY.block_size)
    return bg, jbg


@pytest.fixture(scope="module")
def deployments(col, tiny_collection, tiny_gofs, tmp_path_factory):
    """Root of each deployment: written by the reference or the port,
    plain or with latency tile maps and a delta chain."""
    roots = {"ref_plain": tiny_gofs}
    for name in ("ref_sparse", "port_plain", "port_sparse"):
        root = str(tmp_path_factory.mktemp(name))
        kw = {"sparse_absent": {"latency": INF}} if "sparse" in name else {}
        if name.startswith("ref"):
            j_deploy(tiny_collection, J_TINY, root, **kw)
        else:
            deploy_collection(col, TINY, root, **kw)
        roots[name] = root
    return roots


# ---------------------------------------------------------------------------
# cross-package round trips
# ---------------------------------------------------------------------------

def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


def _eq_dict(a, b, what):
    if b is None:
        assert a is None, what
        return
    assert sorted(a) == sorted(b), what
    for k in b:
        _eq(a[k], b[k], f"{what}[{k}]")


def _eq_sparse(a, b, what):
    for f in ("tiles", "btiles", "rows", "cols", "brows", "bcols", "nnz",
              "bnnz"):
        _eq(getattr(a, f), getattr(b, f), f"{what}.{f}")
    assert (a.block_size, a.total_tiles, a.total_btiles, a.source_bytes) == \
        (b.block_size, b.total_tiles, b.total_btiles, b.source_bytes), what
    assert a.staged_bytes() == b.staged_bytes()
    assert a.occupancy() == b.occupancy()


def _read_counts(store):
    s = store.snapshot_stats()
    return {k: s[k] for k in ("slices_read", "bytes_read", "hits", "misses",
                              "resident", "pinned")}


def _stores_agree(st_, jst, bg, jbg):
    """Every accessor of the two stores, in one order, equal bitwise."""
    assert list(st_.subgraph_ids()) == list(jst.subgraph_ids())
    assert st_.num_timesteps() == jst.num_timesteps()
    _eq(st_.timestamps, jst.timestamps, "timestamps")
    for g in jst.subgraph_ids():
        t, jt = st_.get_topology(g), jst.get_topology(g)
        for f in dataclasses.fields(jt):
            a, b = getattr(t, f.name), getattr(jt, f.name)
            if isinstance(b, np.ndarray):
                _eq(a, b, f"topology {g}.{f.name}")
            else:
                assert a == b, (g, f.name)
        for i in range(jst.num_timesteps()):
            a, b = st_.get_instance(i, g), jst.get_instance(i, g)
            assert (a.timestep, a.timestamp, a.sgid) == \
                (b.timestep, b.timestamp, b.sgid)
            for f in ("vertex_values", "local_edge_values",
                      "remote_edge_values"):
                _eq_dict(getattr(a, f), getattr(b, f), f"{f} t{i} g{g}")
    meta = jst.meta
    for a in meta["edge_attrs"]:
        _eq(st_.edge_attr_matrix(a["name"]), jst.edge_attr_matrix(a["name"]),
            f"edge_attr_matrix {a['name']}")
    for a in meta["vertex_attrs"]:
        _eq(st_.vertex_attr_matrix(a["name"]),
            jst.vertex_attr_matrix(a["name"]),
            f"vertex_attr_matrix {a['name']}")
    last = [jst.num_timesteps() - 1]
    _eq(st_.edge_attr_rows("latency", last, parts=[0], halo=True),
        jst.edge_attr_rows("latency", last, parts=[0], halo=True), "halo rows")
    for zero in (INF, 0.0):
        assert st_.tile_occupancy(bg, "latency", zero=zero) == \
            jst.tile_occupancy(jbg, "latency", zero=zero)
        assert st_.sparse_buckets(bg, "latency", zero=zero) == \
            jst.sparse_buckets(jbg, "latency", zero=zero)
        assert st_.delta_stats("latency", zero=zero) == \
            jst.delta_stats("latency", zero=zero)
    _eq_dict(st_.edge_tile_maps("latency"), jst.edge_tile_maps("latency"),
             "edge_tile_maps")
    _eq_dict(st_.edge_delta_index("latency"),
             jst.edge_delta_index("latency"), "edge_delta_index")
    for zero in (INF, 0.0):
        for a, b in zip(st_.load_blocked(bg, "latency", zero=zero),
                        jst.load_blocked(jbg, "latency", zero=zero)):
            _eq(a, b, f"dense load zero={zero}")
        for delta in (None, True, False):
            _eq_sparse(
                st_.load_blocked(bg, "latency", zero=zero, layout="sparse",
                                 delta=delta),
                jst.load_blocked(jbg, "latency", zero=zero, layout="sparse",
                                 delta=delta),
                f"sparse load zero={zero} delta={delta}")
    assert _read_counts(st_) == _read_counts(jst)


@pytest.mark.parametrize("slots", [0, 4])
@pytest.mark.parametrize("which", ["ref_plain", "ref_sparse", "port_plain",
                                   "port_sparse"])
def test_both_stores_read_each_deployment_alike(deployments, blocked, which,
                                                slots):
    """Each package's store over one deployment (written by the package
    named first): equal instances, matrices, maps, loads and counts."""
    bg, jbg = blocked
    root = deployments[which]
    kw = dict(cache_slots=slots, vertex_projection=("plate", "load"),
              edge_projection=("latency", "mtu"))
    _stores_agree(GoFSStore(root, **kw), JGoFSStore(root, **kw), bg, jbg)


@pytest.mark.parametrize("time_range", [(7200.0, 1e18), (0.0, 7200.0)])
def test_both_stores_agree_under_a_time_filter(deployments, blocked,
                                               time_range):
    bg, jbg = blocked
    root = deployments["port_sparse"]
    kw = dict(vertex_projection=(), edge_projection=("latency",),
              time_range=time_range)
    _stores_agree(GoFSStore(root, **kw), JGoFSStore(root, **kw), bg, jbg)


def _slice_files(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("kind", ["plain", "sparse"])
def test_deployments_of_one_collection_are_equal(deployments, kind):
    ref, port = deployments[f"ref_{kind}"], deployments[f"port_{kind}"]
    files = _slice_files(ref)
    assert files == _slice_files(port)
    assert any(f.endswith(".npz") for f in files)
    for f in files:
        if f.endswith(".json"):
            assert read_json_slice(os.path.join(port, f)) == \
                read_json_slice(os.path.join(ref, f)), f
        else:
            a = read_array_slice(os.path.join(port, f))
            b = read_array_slice(os.path.join(ref, f))
            assert list(a) == list(b), f  # same keys, same order
            _eq_dict(a, b, f)


def test_append_is_not_ported(deployments, col):
    with pytest.raises(NotImplementedError, match="item 5"):
        append_instances(col, deployments["port_plain"])
    with pytest.raises(NotImplementedError, match="item 5"):
        deploy_collection(col, TINY, deployments["port_plain"], append=True)
    store = GoFSStore(deployments["port_plain"])
    with pytest.raises(NotImplementedError, match="item 5"):
        store.refresh()
    with pytest.raises(NotImplementedError, match="item 5"):
        store.append_instances(col)


# ---------------------------------------------------------------------------
# the reference's GoFS cases, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_env(col, deployments):
    tmpl = col.template
    assign = partition_graph(tmpl, TINY.num_partitions, seed=TINY.seed)
    subs = build_subgraphs(tmpl, assign, discover_subgraphs(tmpl, assign))
    return deployments["port_plain"], subs


def test_roundtrip_values(col, port_env):
    root, subs = port_env
    store = GoFSStore(root, vertex_projection=("plate",),
                      edge_projection=("latency",))
    for g in store.subgraph_ids():
        si = store.get_instance(1, g)
        _eq(si.vertex_values["plate"],
            col.vertex_values(1, "plate")[subs[g].vertices], "plate")
        _eq(si.local_edge_values["latency"],
            col.edge_values(1, "latency")[subs[g].local_edge_id], "latency")
        _eq(si.remote_edge_values["latency"],
            col.edge_values(1, "latency")[subs[g].remote_edge_id], "remote")


def test_bin_major_iteration_order(port_env):
    store = GoFSStore(port_env[0])
    homes = [store._sg_home[g] for g in store.subgraph_ids()]
    assert homes == sorted(homes)
    assert [t.sgid for t in store.iter_subgraphs()] == store.subgraph_ids()
    p0 = [t.sgid for t in store.iter_subgraphs(pid=0)]
    assert p0 and all(store._sg_home[g][0] == 0 for g in p0)


def test_constant_attr_not_on_disk(port_env):
    root = port_env[0]
    for p in os.listdir(root):
        if p.startswith("part_"):
            for f in os.listdir(os.path.join(root, p)):
                assert "mtu" not in f and "ip_class" not in f
    store = GoFSStore(root, edge_projection=("mtu",),
                      vertex_projection=("ip_class",))
    si = store.get_instance(0, store.subgraph_ids()[0])
    assert np.all(si.local_edge_values["mtu"] == 1500)
    assert np.all(si.vertex_values["ip_class"] == 3)


def test_projection_reads_fewer_slices(port_env):
    root = port_env[0]
    s_all = GoFSStore(root, cache_slots=0)
    s_one = GoFSStore(root, cache_slots=0, vertex_projection=("plate",),
                      edge_projection=("latency",))
    g = s_all.subgraph_ids()[0]
    s_all.reset_stats()
    s_one.reset_stats()
    s_all.get_instance(0, g)
    s_one.get_instance(0, g)
    assert s_one.stats.slices_read < s_all.stats.slices_read


def test_time_filter_restricts(port_env):
    root = port_env[0]
    full = GoFSStore(root)
    part = GoFSStore(root, time_range=(full.timestamps[1], 1e18))
    assert part.num_timesteps() == full.num_timesteps() - 1
    g = full.subgraph_ids()[0]
    a, b = part.get_instance(0, g), full.get_instance(1, g)
    assert a.timestamp == b.timestamp
    _eq_dict(a.vertex_values, b.vertex_values, "vertex values")
    _eq_dict(a.local_edge_values, b.local_edge_values, "edge values")
    it = list(part.iter_instances(g))
    assert [x.timestep for x in it] == list(range(part.num_timesteps()))


def test_cache_lru_eviction():
    c = SliceCache(slots=2)
    loads = []
    for key in ["a", "b", "a", "c", "b"]:
        c.get(key, lambda k=key: loads.append(k))
    # a,b -> miss; a hit; c miss (evicts b); b miss again
    assert loads == ["a", "b", "c", "b"]
    assert c.hits == 1 and c.misses == 4


def test_caching_reduces_reads(port_env):
    root = port_env[0]
    kw = dict(vertex_projection=(), edge_projection=("latency",))
    cold = GoFSStore(root, cache_slots=0, **kw)
    warm = GoFSStore(root, cache_slots=14, **kw)
    g = cold.subgraph_ids()[0]
    cold.reset_stats()
    warm.reset_stats()
    for t in range(cold.num_timesteps()):
        cold.get_instance(t, g)
        warm.get_instance(t, g)
    assert warm.stats.slices_read < cold.stats.slices_read


def test_temporal_packing_amortizes(col, tmp_path):
    """i2 packing + cache reads fewer slices than i1 for a time scan."""
    outs = []
    for ipack in (1, 2):
        root = str(tmp_path / f"i{ipack}")
        deploy_collection(col, dataclasses.replace(
            TINY, instances_per_slice=ipack), root)
        store = GoFSStore(root, cache_slots=14, vertex_projection=(),
                          edge_projection=("latency",))
        store.reset_stats()
        for g in store.subgraph_ids():
            for t in range(store.num_timesteps()):
                store.get_instance(t, g)
        outs.append(store.stats.slices_read)
    assert outs[1] < outs[0]


def test_gofs_provider_matches_inmemory(col, port_env):
    root, subs = port_env
    store = GoFSStore(root, vertex_projection=(),
                      edge_projection=("latency", "active"))
    mem = InMemoryProvider(col, subs, edge_attrs=("latency", "active"))
    a, ra = sssp.run_host(store, 0)
    b, rb = sssp.run_host(mem, 0)
    assert sorted(a) == sorted(b)
    for g in a:
        _eq(a[g], b[g], f"sssp {g}")
    assert ra.stats == rb.stats


@settings(max_examples=5, deadline=None)
@given(
    ipack=st.integers(1, 4),
    bins=st.integers(1, 5),
    slots=st.sampled_from([0, 4, 16]),
    seed=st.integers(0, 2**31 - 1),
)
def test_gofs_roundtrip_any_layout(tmp_path_factory, ipack, bins, slots,
                                   seed):
    """Deploy -> read is the identity for any layout configuration."""
    cfg = dataclasses.replace(
        TINY, num_vertices=150, num_instances=3, seed=seed % 1000,
        instances_per_slice=ipack, bins_per_partition=bins,
    )
    tsg = generate_collection(cfg, num_plates=3)
    root = str(tmp_path_factory.mktemp(f"g{ipack}{bins}{slots}"))
    deploy_collection(tsg, cfg, root)
    store = GoFSStore(root, cache_slots=slots, vertex_projection=("plate",),
                      edge_projection=("latency",))
    assign = partition_graph(tsg.template, cfg.num_partitions, seed=cfg.seed)
    subs = build_subgraphs(tsg.template, assign,
                           discover_subgraphs(tsg.template, assign))
    assert sorted(store.subgraph_ids()) == sorted(subs)
    for g in store.subgraph_ids():
        for t in range(store.num_timesteps()):
            si = store.get_instance(t, g)
            _eq(si.vertex_values["plate"],
                tsg.vertex_values(t, "plate")[subs[g].vertices], "plate")
            _eq(si.local_edge_values["latency"],
                tsg.edge_values(t, "latency")[subs[g].local_edge_id],
                "latency")


def test_load_blocked_rejects_unknown_layout(port_env, blocked):
    with pytest.raises(ValueError):
        GoFSStore(port_env[0]).load_blocked(blocked[0], "latency",
                                            layout="csr")


# ---------------------------------------------------------------------------
# the slice cache under concurrent load (tests/test_cache_stress.py)
# ---------------------------------------------------------------------------

KEYS = 40
VALUE_BYTES = 8 * 1024  # 2048 float32 per value
N_THREADS = 8
OPS_PER_THREAD = 300


def _value_for(key: int) -> np.ndarray:
    return np.full(VALUE_BYTES // 4, key, np.float32)


def _storm(cache, pinned_keys):
    """N threads hammer overlapping key ranges; returns collected errors
    and the pinned loaders' call counts."""
    barrier = threading.Barrier(N_THREADS)
    errors = []
    pin_loads = {k: 0 for k in pinned_keys}
    pin_lock = threading.Lock()

    def pin_loader(k):
        def load():
            with pin_lock:
                pin_loads[k] += 1
            return _value_for(k)
        return load

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            barrier.wait(timeout=30)
            for i in range(OPS_PER_THREAD):
                if i % 7 == 0:
                    k = int(rng.choice(pinned_keys))
                    got = cache.get(f"pin/{k}", pin_loader(k), pin=True)
                else:
                    k = int(rng.integers(0, KEYS))
                    got = cache.get(f"lru/{k}", lambda k=k: _value_for(k))
                assert got[0] == k, "value for the wrong key"
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((tid, e))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "cache deadlocked (worker did not join)"
    return errors, pin_loads


@pytest.mark.parametrize("slots,budget", [
    (6, 3 * VALUE_BYTES),   # byte budget binds before the slot count
    (4, None),              # slot count only
    (64, 5 * VALUE_BYTES),  # slots slack, budget binds
])
def test_concurrent_storm_keeps_invariants(slots, budget):
    cache = SliceCache(slots=slots, byte_budget=budget)
    pinned = [100, 101, 102]
    errors, pin_loads = _storm(cache, pinned)
    assert not errors, errors
    stats = cache.stats()
    assert stats["resident"] <= slots
    if budget is not None:
        assert stats["resident_bytes"] <= budget
    with cache._lock:
        assert cache._bytes == sum(cache._sizes.values())
        assert set(cache._sizes) == set(cache._data)
        assert all(v == VALUE_BYTES for v in cache._sizes.values())
    for k in pinned:
        def must_not_load():  # pragma: no cover - the assertion
            raise AssertionError("pinned entry was lost")
        assert cache.get(f"pin/{k}", must_not_load, pin=True)[0] == k
        assert pin_loads[k] >= 1
    assert stats["hits"] + stats["misses"] == N_THREADS * OPS_PER_THREAD


def test_slots_zero_still_pins_under_concurrency():
    cache = SliceCache(slots=0, byte_budget=None)
    errors, _ = _storm(cache, pinned_keys=[7, 8])
    assert not errors, errors
    stats = cache.stats()
    assert stats["resident"] == 0 and stats["resident_bytes"] == 0
    assert stats["pinned"] == 2


def test_oversized_value_never_resident():
    cache = SliceCache(slots=8, byte_budget=VALUE_BYTES // 2)
    assert cache.get("big", lambda: _value_for(1))[0] == 1
    stats = cache.stats()
    assert (stats["resident"], stats["resident_bytes"],
            stats["evictions"]) == (0, 0, 1)


def test_value_nbytes_covers_containers():
    arr = np.zeros(16, np.float32)
    assert _value_nbytes(arr) == 64
    assert _value_nbytes({"a": arr, "b": [arr, arr]}) == 192
    assert _value_nbytes(("x", 3)) == 0


def test_invalidate_drops_matching_lru_and_pinned_only():
    cache = SliceCache(slots=8, byte_budget=None)
    for k in range(4):
        cache.get(f"lru/{k}", lambda k=k: _value_for(k))
    cache.get("pin/tilemap", lambda: _value_for(99), pin=True)
    cache.get("pin/delta", lambda: _value_for(98), pin=True)
    assert cache.invalidate(
        lambda key: key.startswith("pin/") or key == "lru/3") == 3
    loads = []
    got = cache.get("lru/0", lambda: (loads.append(1), _value_for(0))[1])
    assert got[0] == 0 and not loads
    got = cache.get("pin/delta",
                    lambda: (loads.append(1), _value_for(55))[1], pin=True)
    assert got[0] == 55 and loads == [1]
    stats = cache.stats()
    assert stats["pinned"] == 1
    assert stats["resident"] == 3
    assert stats["resident_bytes"] == 3 * VALUE_BYTES
    cache.clear()
    assert cache.stats()["resident"] == 0 and cache.stats()["pinned"] == 0


def test_invalidate_races_getters_without_deadlock():
    budget = 4 * VALUE_BYTES
    cache = SliceCache(slots=16, byte_budget=budget)
    stop = threading.Event()
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                k = int(rng.integers(0, KEYS))
                pin = k % 5 == 0
                got = cache.get(f"{'pin' if pin else 'lru'}/{k}",
                                lambda k=k: _value_for(k), pin=pin)
                assert got[0] == k, "value for the wrong key"
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((tid, e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for _ in range(300):
        cache.invalidate(lambda key: key.endswith(("0", "5")))
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "cache deadlocked under invalidation"
    assert not errors, errors
    assert cache.stats()["resident_bytes"] <= budget


# ---------------------------------------------------------------------------
# the slice as a whole: quickstart steps 1-3 and 5, engines from the store
# ---------------------------------------------------------------------------

QUICKSTART = dict(
    name="quickstart", num_vertices=2_000, avg_degree=3.0, num_instances=6,
    num_partitions=4, block_size=64, instances_per_slice=3,
    bins_per_partition=4, cache_slots=14, seed=1,
)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    """Quickstart steps 1-3 in both packages: generate, deploy with
    latency tile maps, host SSSP on the store."""
    from repro.configs.base import GraphConfig as JGraphConfig

    out = {}
    for which, cfg_t, gen, deploy, store_t, sp, build, part in (
            ("port", GraphConfig, generate_collection, deploy_collection,
             GoFSStore, sssp, build_blocked, partition_graph),
            ("ref", JGraphConfig, j_generate, j_deploy, JGoFSStore, j_sssp,
             j_build_blocked, j_partition_graph)):
        cfg = cfg_t(**QUICKSTART)
        tsg = gen(cfg)
        root = str(tmp_path_factory.mktemp(f"quickstart_{which}"))
        meta = deploy(tsg, cfg, root, sparse_absent={"latency": INF})
        store = store_t(root, cache_slots=14, vertex_projection=(),
                        edge_projection=("latency", "active"))
        dists, res = sp.run_host(store, source_vertex=0)
        d_host = np.full(tsg.template.num_vertices, INF)
        for g, d in dists.items():
            d_host[store.get_topology(g).vertices] = d
        tmpl = tsg.template
        bg = build(tmpl, part(tmpl, cfg.num_partitions, seed=cfg.seed),
                   cfg.block_size)
        out[which] = dict(tsg=tsg, meta=meta, store=store, d_host=d_host,
                          res=res, reads=(store.stats.slices_read,
                                          store.cache.stats()["hit_rate"]),
                          bg=bg)
    return out


def test_quickstart_steps_1_to_3(quickstart):
    p, r = quickstart["port"], quickstart["ref"]
    assert p["meta"] == r["meta"]
    _eq(p["d_host"], r["d_host"], "host SSSP distances")
    assert dataclasses.asdict(p["res"].stats) == \
        dataclasses.asdict(r["res"].stats)
    assert p["reads"] == r["reads"]
    assert np.isfinite(p["d_host"]).sum() > 1


@pytest.mark.parametrize("layout", ["dense", "sparse", "delta"])
def test_quickstart_step_5_sssp_from_the_store(quickstart, layout):
    """load_blocked -> TemporalEngine sequential SSSP: port == reference
    bitwise (values, final, supersteps, local sweeps), and equal to the
    host run of step 3 in reachability, within rtol 1e-6 (the reference's
    host-vs-engine check)."""
    p, r = quickstart["port"], quickstart["ref"]
    jprog = J.min_plus_program("sssp", init=J.source_init(0))
    prog = T.min_plus_program("sssp", init=T.source_init(0))
    kw = {} if layout == "dense" else dict(layout="sparse",
                                           delta=layout == "delta")
    st_, jst = p["store"], r["store"]
    got_b = st_.load_blocked(p["bg"], "latency", **kw)
    want_b = jst.load_blocked(r["bg"], "latency", **kw)
    eng = T.TemporalEngine(p["bg"], device="cpu")
    jeng = J.TemporalEngine(r["bg"], use_pallas=False)
    if layout == "dense":
        got = eng.run(prog, tiles=got_b[0], btiles=got_b[1],
                      pattern="sequential")
        want = jeng.run(jprog, tiles=want_b[0], btiles=want_b[1],
                        pattern="sequential")
    else:
        assert (got_b.source_bytes is not None) == (layout == "delta")
        _eq_sparse(got_b, want_b, layout)
        got = eng.run(prog, sparse=got_b, pattern="sequential")
        want = jeng.run(jprog, sparse=want_b, pattern="sequential")
    for f in ("values", "final"):
        _eq(getattr(got, f), np.asarray(getattr(want, f)), f)
    for k in ("supersteps", "local_sweeps"):
        assert np.array_equal(got.stats[k], np.asarray(want.stats[k])), k
    fin = np.isfinite(p["d_host"])
    assert np.array_equal(np.isfinite(got.final), fin)
    np.testing.assert_allclose(got.final[fin], p["d_host"][fin], rtol=1e-6)


def test_pagerank_from_the_store(quickstart):
    """edge_attr_matrix("active") -> outdegree weights -> TemporalEngine
    PageRank: port within rtol 2e-5 of the reference."""
    p, r = quickstart["port"], quickstart["ref"]
    V = p["tsg"].template.num_vertices
    act = p["store"].edge_attr_matrix("active")
    _eq(act, r["store"].edge_attr_matrix("active"), "active")
    w = pagerank.edge_weights_for_instances(p["tsg"].template.src, act, V)
    jw = j_pagerank.edge_weights_for_instances(
        r["tsg"].template.src, act, V)
    _eq(w, jw, "pagerank weights")
    got = T.TemporalEngine(p["bg"], device="cpu").run(
        T.pagerank_program(V, iters=10), w, pattern="independent")
    want = J.TemporalEngine(r["bg"], use_pallas=False).run(
        J.pagerank_program(V, iters=10), jw, pattern="independent")
    assert np.all(np.isfinite(got.values))
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               rtol=PR_TOL, atol=PR_ATOL)
