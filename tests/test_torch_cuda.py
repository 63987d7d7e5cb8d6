"""Card-only tests of the port: each CUDA kernel against its plain version,
and the engine on the card against the engine on the CPU.

This file imports nothing of the JAX package, so it also runs on a machine
with the card and no JAX (the repository's ``conftest.py`` imports the JAX
package, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import GraphConfig
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core import engine as T
from repro_torch.core.algorithms.pagerank import edge_weights_for_instances
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref

TOL = 2e-5  # tests/test_kernels.py:46


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py "
                    "holds the same comparisons)")
    return torch.device("cuda")


def _agree(got, want, semiring):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    if semiring is MIN_PLUS:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        torch.testing.assert_close(got[fin], want[fin], rtol=TOL, atol=TOL)


def _inputs(rng, sr, shape, B, P=3, nvb=4, nbb=5, T_=6):
    """Random blocked structure (sorted valid columns, padding last) and
    states for one fused call shape."""
    nvb_in = nbb if shape == "consume" else nvb
    tiles = np.full((P, T_, B, B), sr.zero, np.float32)
    rows = np.full((P, T_), -1, np.int32)
    cols = np.full((P, T_), -1, np.int32)
    for p in range(P):
        n = int(rng.integers(0, T_ + 1)) if p else T_
        cols[p, :n] = np.sort(rng.integers(0, nvb, n))
        rows[p, :n] = rng.integers(0, nvb_in, n)
        m = rng.random((n, B, B)) < 0.4
        blk = tiles[p, :n]
        blk[m] = rng.random(int(m.sum()))
    x = rng.random((P, nvb, B)).astype(np.float32)
    if shape == "consume":
        x_in = rng.random((1, nbb, B)).astype(np.float32)
        x_comb, x_ref = x, rng.random((P, nvb, B)).astype(np.float32)
    elif shape == "sweep":
        x_in = x_comb = x_ref = x
    else:  # plain spmv: combine with the semiring zero
        x_in, x_ref, x_comb = x, x, np.full_like(x, sr.zero)
    vmask = rng.random((P, nvb, B)) < 0.9
    return tiles, rows, cols, x_in, x_comb, x_ref, vmask


@pytest.mark.parametrize("B", [32, 64, 128])
@pytest.mark.parametrize("sr", [MIN_PLUS, PLUS_MUL], ids=lambda s: s.name)
@pytest.mark.parametrize("shape", ["sweep", "consume", "spmv"])
def test_kernels_match_plain(cuda, B, sr, shape):
    rng = np.random.default_rng(B + len(shape))
    args = [torch.as_tensor(np.ascontiguousarray(a), device=cuda)
            for a in _inputs(rng, sr, shape, B)]
    ko, kc = fused_step_cuda(*args, sr)
    po, pc = fused_step_ref(*args, sr)
    _agree(ko, po, sr)
    assert torch.equal(kc, pc)
    # no vote, with and without the combine (PageRank's step)
    for comb in (args[4], None):
        part = args[:4] + [comb, None, None]
        ko, kc = fused_step_cuda(*part, sr, n_out_blocks=args[4].shape[1])
        po, pc = fused_step_ref(*part, sr, n_out_blocks=args[4].shape[1])
        assert kc is None and pc is None
        _agree(ko, po, sr)
    tiles, rows, cols, x_in, x_comb = args[:5]
    x = x_in.reshape(x_in.shape[0], -1)
    nnz = (cols >= 0).sum(1).to(torch.int32)
    for kw in ({}, {"nnz": nnz}, {"nnz": (nnz - 1).clamp_min(0)}):
        k = spmv_blocked_cuda(tiles, rows, cols, x, sr,
                              n_out_blocks=x_comb.shape[1], **kw)
        p = spmv_blocked_ref(tiles, rows, cols, x, sr,
                             n_out_blocks=x_comb.shape[1], **kw)
        _agree(k, p, sr)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tiles = torch.zeros(1, 2, 8, 8, device=cuda)
    idx = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    x = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        spmv_blocked_cuda(tiles, idx.long(), idx, x, MIN_PLUS)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_blocked_cuda(tiles.transpose(2, 3), idx, idx, x, MIN_PLUS)
    with pytest.raises(ValueError, match="one device"):
        spmv_blocked_cuda(tiles, idx.cpu(), idx, x, MIN_PLUS)
    with pytest.raises(ValueError, match="multiple of 4"):
        spmv_blocked_cuda(torch.zeros(1, 2, 6, 6, device=cuda), idx, idx,
                          torch.zeros(1, 6, device=cuda), MIN_PLUS)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_engine_on_card_matches_cpu(cuda, layout):
    """TR_TINY through the engine on the card (both kernel modes) ==
    the same engine on the CPU (plain versions): bitwise for min-plus,
    within 2e-5 for PageRank; the kernels were launched."""
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions),
                       TR_TINY.block_size)
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)
    sssp = T.min_plus_program("sssp", init=T.source_init(0))
    pr = T.pagerank_program(t.num_vertices, iters=8)
    cpu = T.TemporalEngine(bg, device="cpu", layout=layout)
    want = cpu.run(sssp, lat, pattern="sequential")
    want_pr = cpu.run(pr, prw, pattern="independent")
    before = (spmv_blocked_cuda.launches, fused_step_cuda.launches)
    for mode in ("spmv", "fused"):
        eng = T.TemporalEngine(bg, layout=layout, use_pallas=mode)
        got = eng.run(sssp, lat, pattern="sequential")
        assert np.array_equal(got.values, want.values)
        for k in ("supersteps", "local_sweeps"):
            assert np.array_equal(got.stats[k], want.stats[k])
        got_pr = eng.run(pr, prw, pattern="independent")
        np.testing.assert_allclose(got_pr.values, want_pr.values, rtol=TOL,
                                   atol=TOL)
    assert spmv_blocked_cuda.launches > before[0]
    assert fused_step_cuda.launches > before[1]


def test_default_mode_on_card_is_spmv_and_off_raises(cuda):
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions),
                       TR_TINY.block_size)
    assert T.TemporalEngine(bg).kernel_mode == "spmv"
    with pytest.raises(ValueError, match="test oracles"):
        T.TemporalEngine(bg, use_pallas="off")


@pytest.mark.parametrize("load", ["dense", "delta"])
def test_store_loaded_batches_through_both_kernels(cuda, tmp_path, load):
    """TR_TINY deployed to GoFS and loaded back (dense, or the sparse
    batch rebuilt from the delta chain), each instance's local sweep and
    boundary consume through both kernels against their plain versions:
    min-plus bitwise, plus-mul within 2e-5, votes equal."""
    from repro_torch.gofs import GoFSStore, deploy_collection

    col = generate_collection(TR_TINY)
    t = col.template
    assign = partition_graph(t, TR_TINY.num_partitions, seed=TR_TINY.seed)
    bg = build_blocked(t, assign, TR_TINY.block_size)
    root = str(tmp_path / "gofs")
    deploy_collection(col, TR_TINY, root, assign=assign,
                      sparse_absent={"latency": float("inf")})
    store = GoFSStore(root)
    if load == "dense":
        tiles, btiles = store.load_blocked(bg, "latency")
        idx = [(bg.tiles_rc[..., 0], bg.tiles_rc[..., 1],
                bg.btiles_rc[..., 0], bg.btiles_rc[..., 1])] * len(col)
    else:
        sp = store.load_blocked(bg, "latency", layout="sparse")
        assert sp.source_bytes is not None  # the delta route was taken
        tiles, btiles = sp.tiles, sp.btiles
        idx = list(zip(sp.rows, sp.cols, sp.brows, sp.bcols))
    B, nvb, nbb = bg.block_size, bg.vp // bg.block_size, \
        bg.num_boundary // bg.block_size
    rng = np.random.default_rng(7)
    before = (spmv_blocked_cuda.launches, fused_step_cuda.launches)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=cuda)

    for i, (rows, cols, brows, bcols) in enumerate(idx):
        x = dev(rng.random((bg.n_parts, nvb, B)).astype(np.float32) * 50)
        xb = dev(rng.random((1, nbb, B)).astype(np.float32) * 50)
        vm = dev(bg.global_of.reshape(bg.n_parts, nvb, B) >= 0)
        lt, bt = dev(tiles[i]), dev(btiles[i])
        assert lt.dtype == torch.float32 and lt.is_contiguous()
        assert lt.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0
        r, c, br, bc = (dev(a.astype(np.int32)) for a in (rows, cols,
                                                            brows, bcols))
        for x_in, ti, ri, ci in ((x, lt, r, c), (xb, bt, br, bc)):
            ko, kc = fused_step_cuda(ti, ri, ci, x_in, x, x, vm, MIN_PLUS)
            po, pc = fused_step_ref(ti, ri, ci, x_in, x, x, vm, MIN_PLUS)
            _agree(ko, po, MIN_PLUS)
            assert torch.equal(kc, pc)
            flat = x_in.reshape(x_in.shape[0], -1)
            for sr in (MIN_PLUS, PLUS_MUL):
                tt = ti if sr is MIN_PLUS else torch.where(
                    torch.isfinite(ti), ti / 100, torch.zeros_like(ti))
                _agree(spmv_blocked_cuda(tt, ri, ci, flat, sr,
                                         n_out_blocks=nvb),
                       spmv_blocked_ref(tt, ri, ci, flat, sr,
                                        n_out_blocks=nvb), sr)
    assert spmv_blocked_cuda.launches > before[0]
    assert fused_step_cuda.launches > before[1]


# ---------------------------------------------------------------------------
# the graph kernels' walk: skewed runs, determinism, CUDA graphs
# ---------------------------------------------------------------------------

def _skewed(sr, rng, B=64, nvb=6, nbb=5):
    """Partition 0: every tile in one output block (225 tiles, 29 chunks
    at B = 64); partition 1: runs of 1, 7, 8, 9 and 200 tiles; partition
    2: all padding; partition 3: one run of 30 tiles.  States for the
    sweep (x per partition) and the consume (x shared)."""
    P, T_ = 4, 225
    cols = np.full((P, T_), -1, np.int32)
    cols[0] = 4
    cols[1] = np.repeat([0, 1, 2, 3, 5], [1, 7, 8, 9, 200])
    cols[3, :30] = 2
    tiles = np.full((P, T_, B, B), sr.zero, np.float32)
    live = (rng.random((P, T_, B, B)) < 0.3) & (cols >= 0)[..., None, None]
    tiles[live] = rng.random(int(live.sum()))
    x = rng.random((P, nvb, B)).astype(np.float32)
    xb = rng.random((1, nbb, B)).astype(np.float32)
    rows = np.where(cols >= 0, rng.integers(0, nvb, (P, T_)), -1)
    brows = np.where(cols >= 0, rng.integers(0, nbb, (P, T_)), -1)
    vm = rng.random((P, nvb, B)) < 0.9
    return [np.ascontiguousarray(a) for a in (
        tiles, rows.astype(np.int32), brows.astype(np.int32), cols, x, xb,
        vm)]


@pytest.mark.parametrize("sr", [MIN_PLUS, PLUS_MUL], ids=lambda s: s.name)
def test_kernels_on_skewed_runs(cuda, sr):
    """Both kernels against their plain versions on skewed runs, with the
    x of each partition and a shared x; a plan built on the host gives
    the same output as the one each wrapper builds on the device."""
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    tiles, rows, brows, cols, x, xb, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            sr, np.random.default_rng(3))]
    P, _, B, _ = tiles.shape
    nvb = x.shape[1]
    plan = to_device(walk_plan(cols.cpu().numpy(), nvb,
                               chunk=default_chunk(B)), cuda)
    assert int(plan.count.max()) > 1  # runs of several chunks
    for r, xin, xref in ((rows, x, x), (brows, xb, x.flip(2).contiguous())):
        flat = xin.reshape(xin.shape[0], -1)
        k = spmv_blocked_cuda(tiles, r, cols, flat, sr, n_out_blocks=nvb)
        _agree(k, spmv_blocked_ref(tiles, r, cols, flat, sr,
                                   n_out_blocks=nvb), sr)
        assert torch.equal(k, spmv_blocked_cuda(
            tiles, r, cols, flat, sr, n_out_blocks=nvb, plan=plan))
        ko, kc = fused_step_cuda(tiles, r, cols, xin, x, xref, vm, sr,
                                 plan=plan)
        po, pc = fused_step_ref(tiles, r, cols, xin, x, xref, vm, sr)
        _agree(ko, po, sr)
        assert torch.equal(kc, pc)
        ko, _ = fused_step_cuda(tiles, r, cols, xin, None, None, None, sr,
                                n_out_blocks=nvb)
        assert torch.equal(ko.reshape(k.shape), k)  # one walk, one order


def test_plus_mul_launches_repeat_bitwise(cuda):
    tiles, rows, brows, cols, x, xb, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            PLUS_MUL, np.random.default_rng(4))]
    flat = xb.reshape(1, -1)
    a = spmv_blocked_cuda(tiles, brows, cols, flat, PLUS_MUL,
                          n_out_blocks=x.shape[1])
    b = spmv_blocked_cuda(tiles, brows, cols, flat, PLUS_MUL,
                          n_out_blocks=x.shape[1])
    assert torch.equal(a, b)
    fa, _ = fused_step_cuda(tiles, rows, cols, x, x, None, None, PLUS_MUL)
    fb, _ = fused_step_cuda(tiles, rows, cols, x, x, None, None, PLUS_MUL)
    assert torch.equal(fa, fb)


@pytest.mark.parametrize("kernel", ["spmv", "fused"])
def test_cuda_graph_replays_match_eager(cuda, kernel):
    """20 launches captured in one CUDA graph and replayed: each gives the
    eager output (the run counters of the multi-chunk combine reset
    themselves), and the fused vote is right every time."""
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    tiles, rows, brows, cols, x, xb, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            PLUS_MUL, np.random.default_rng(5))]
    nvb, B = x.shape[1], x.shape[2]
    plan = to_device(walk_plan(cols.cpu().numpy(), nvb,
                               chunk=default_chunk(B)), cuda)
    xref = x + 1

    def call():
        if kernel == "spmv":
            return spmv_blocked_cuda(tiles, brows, cols, xb.reshape(1, -1),
                                     PLUS_MUL, n_out_blocks=nvb, plan=plan),
        return fused_step_cuda(tiles, brows, cols, xb, x, xref, vm,
                               PLUS_MUL, plan=plan)

    eager = call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for _ in range(20):
            outs.append(call())
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for out in outs:
            for got, want in zip(out, eager):
                assert torch.equal(got, want)
    assert int(plan.counters.abs().sum()) == 0


def test_spmv_and_fused_pagerank_bitwise(cuda):
    """Both kernel modes run one walk in one order: PageRank's ranks are
    bitwise equal between them."""
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions),
                       TR_TINY.block_size)
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)
    pr = T.pagerank_program(t.num_vertices, iters=8)
    got = [T.TemporalEngine(bg, use_pallas=m).run(
        pr, prw, pattern="independent").values for m in ("spmv", "fused")]
    assert np.array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# LM serving: the attention kernels and the model on the card
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # test_kernels.py


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, K, d, causal, window, q_offset, dtype)
    (2, 64, 64, 4, 2, 32, True, 0, 0, torch.float32),
    (2, 32, 32, 4, 1, 16, False, 0, 0, torch.float32),
    (1, 32, 96, 4, 2, 32, True, 0, 64, torch.float32),
    (1, 50, 50, 9, 1, 128, True, 16, 0, torch.float32),
    (1, 64, 64, 4, 2, 32, True, 0, 0, torch.bfloat16),
    (2, 100, 612, 36, 4, 128, True, 256, 512, torch.bfloat16),
    (1, 77, 130, 8, 2, 64, False, 0, 0, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    B, Sq, Skv, H, K, d, causal, window, qoff, dt = case
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn(B, Sq, H, d, generator=g, device=cuda).to(dt)
    kv = torch.randn(2, B, Skv + 3, K, d, generator=g, device=cuda).to(dt)
    k, v = kv[0, :, :Skv], kv[1, :, :Skv]  # strided, as cache slices are
    kw = dict(causal=causal, window=window, q_offset=qoff)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, **kw)
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), mha_ref(q, k, v, **kw).float(),
                               rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])


def _cache_slices(cuda, B, Skv, K, d, dt, seed, spare=37):
    """k, v as the serving path passes them: slices [0, Skv) of one KV
    cache with spare slots, strided in batch and row."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cache = torch.randn(2, B, Skv + spare, K, d, generator=g,
                        device=cuda).to(dt)
    return cache[0, :, :Skv], cache[1, :, :Skv], g


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, K, d, causal, window, q_offset), bf16: the wgmma route
    (1, 200, 200, 4, 2, 64, True, 50, 0),  # d = 64, ragged, window < 128
    (2, 150, 330, 4, 1, 128, True, 200, 180),  # window > 128, q_offset > 0
    (1, 300, 300, 36, 4, 128, True, 100, 0),  # G = 9 over K = 4
    (1, 257, 390, 36, 4, 128, True, 0, 133),  # causal only, continued
    (2, 129, 255, 8, 2, 64, False, 0, 0),  # no mask but the ragged tail
    (1, 40, 1000, 9, 1, 128, True, 700, 960),  # one ragged query block
])
def test_flash_wgmma_matches_plain(cuda, case):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    B, Sq, Skv, H, K, d, causal, window, qoff = case
    dt = torch.bfloat16
    k, v, g = _cache_slices(cuda, B, Skv, K, d, dt, Sq + Skv)
    assert k.stride(0) == (Skv + 37) * K * d  # the cache's, not Skv's
    q = torch.randn(B, Sq, H, d, generator=g, device=cuda).to(dt)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    before = flash_attention_cuda.launches_by_route["bf16_wgmma"]
    got = flash_attention_cuda(q, k, v, **kw)
    assert flash_attention_cuda.launches_by_route["bf16_wgmma"] == before + 1
    torch.testing.assert_close(got.float(), mha_ref(q, k, v, **kw).float(),
                               rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])


def test_flash_wgmma_graph_replay_is_bitwise(cuda):
    """Launches captured in a CUDA graph (the tensor maps are kernel
    arguments, captured by value) give the eager call's bits, as does a
    second eager call."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    k, v, g = _cache_slices(cuda, 2, 300, 4, 128, torch.bfloat16, 11)
    q = torch.randn(2, 300, 36, 128, generator=g, device=cuda).to(
        torch.bfloat16)
    kw = dict(causal=True, window=128, q_offset=0)
    eager = flash_attention_cuda(q, k, v, **kw)
    assert torch.equal(flash_attention_cuda(q, k, v, **kw), eager)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [flash_attention_cuda(q, k, v, **kw) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, eager)


def test_flash_routes_by_dtype_and_head_dim(cuda):
    """bf16 with d in {64, 128} takes the wgmma kernel, bf16 with d in
    {16, 32} the mma.sync one, float32 the CUDA-core one."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    for dt, d, route in ((torch.bfloat16, 128, "bf16_wgmma"),
                         (torch.bfloat16, 64, "bf16_wgmma"),
                         (torch.bfloat16, 32, "bf16_mma_sync"),
                         (torch.bfloat16, 16, "bf16_mma_sync"),
                         (torch.float32, 128, "f32")):
        q = torch.randn(1, 70, 4, d, device=cuda).to(dt)
        before = dict(flash_attention_cuda.launches_by_route)
        flash_attention_cuda(q, q[:, :, :2], q[:, :, :2], window=30)
        after = flash_attention_cuda.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}


@pytest.mark.parametrize("case", [
    # (B, S, H, K, d, window, dtype)
    (2, 128, 4, 2, 32, 0, torch.float32),
    (3, 128, 4, 4, 32, 48, torch.float32),
    (3, 100, 9, 1, 128, 0, torch.float32),
    (2, 128, 8, 2, 64, 0, torch.bfloat16),
    (4, 5000, 36, 4, 128, 4096, torch.bfloat16),
    (2, 1000, 16, 1, 128, 0, torch.bfloat16),
])
def test_decode_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_ref

    B, S, H, K, d, window, dt = case
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, H, d, generator=g, device=cuda).to(dt)
    k = torch.randn(B, S, K, d, generator=g, device=cuda).to(dt)
    v = torch.randn(B, S, K, d, generator=g, device=cuda).to(dt)
    lens = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    lens[0] = 1
    got = decode_attention_cuda(q, k, v, lens, window=window)
    torch.testing.assert_close(
        got.float(), decode_ref(q, k, v, lens, window=window).float(),
        rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])


@pytest.mark.parametrize("case", [
    # (B, S, H, K, d, window, lengths), bf16: the ring route.  Lengths of
    # 1, shorter than the window, not a multiple of 64, past the cache
    # (clamped; with a window its start moves past the clamp), and <= 0
    (4, 300, 36, 4, 128, 64, [1, 37, 300, 310]),  # G = 9
    (3, 500, 16, 1, 64, 0, [0, 777, 129]),  # G = 16, d = 64
    (2, 5000, 36, 4, 128, 4096, [5000, 4097]),  # the serving window
    (2, 1000, 18, 2, 128, 200, [-3, 999]),
    (1, 3000, 9, 1, 128, 0, [2999]),  # B*K = 1: 47 splits
    (1, 200, 16, 1, 64, 150, [77]),  # more splits than blocks
    (40, 200, 16, 4, 64, 0, None),  # B*K = 160 > SMs: one split
])
def test_decode_ring_matches_plain(cuda, case):
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_ref

    B, S, H, K, d, window, lengths = case
    dt = torch.bfloat16
    k, v, g = _cache_slices(cuda, B, S, K, d, dt, S + B)
    assert k.stride(0) == (S + 37) * K * d  # the cache's, not S's
    q = torch.randn(B, H, d, generator=g, device=cuda).to(dt)
    if lengths is None:
        lens = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                             dtype=torch.int32)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attention_cuda.launches_by_route["bf16_ring"]
    got = decode_attention_cuda(q, k, v, lens, window=window)
    assert decode_attention_cuda.launches_by_route["bf16_ring"] == before + 1
    hi = lens.long().clamp(max=S)
    lo = (lens.long() - window).clamp(min=0) if window else 0 * hi
    empty = hi <= lo  # no valid slot: 0, as in the TPU kernel
    assert (got[empty] == 0).all()
    torch.testing.assert_close(
        got[~empty].float(),
        decode_ref(q, k, v, lens, window=window)[~empty].float(),
        rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])


def test_decode_ring_graph_replay_is_bitwise(cuda):
    """With several splits a second launch combines them in split order:
    a second eager call and launches replayed from a CUDA graph give the
    first call's bits."""
    from repro_torch.kernels.decode_attention import kernel

    k, v, g = _cache_slices(cuda, 2, 3000, 4, 128, torch.bfloat16, 12)
    q = torch.randn(2, 36, 128, generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.tensor([2990, 1777], dtype=torch.int32, device=cuda)
    assert kernel.num_splits(8, 2048, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    eager = kernel.decode_attention_cuda(q, k, v, lens, window=2048)
    assert torch.equal(kernel.decode_attention_cuda(q, k, v, lens,
                                                    window=2048), eager)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernel.decode_attention_cuda(q, k, v, lens, window=2048)
                for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, eager)


def test_decode_ring_first_call_inside_a_graph_capture(cuda):
    """The first call at a shape (here B*K = 6, 11 splits) may come inside
    a CUDA-graph capture: an eager call made before the graph's first
    replay, and the replay, give the plain version's result."""
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.decode_attention.ref import decode_ref

    dt = torch.bfloat16
    k, v, g = _cache_slices(cuda, 3, 900, 2, 64, dt, 5)
    q = torch.randn(3, 18, 64, generator=g, device=cuda).to(dt)
    lens = torch.tensor([900, 433, 65], dtype=torch.int32, device=cuda)
    kernel.decode_attention_cuda(q[:1], k[:1], v[:1], lens[:1], window=64)
    torch.cuda.synchronize()  # the library and the ring kernel are loaded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel.decode_attention_cuda(q, k, v, lens, window=700)
    eager = kernel.decode_attention_cuda(q, k, v, lens, window=700)
    torch.testing.assert_close(
        eager.float(), decode_ref(q, k, v, lens, window=700).float(),
        rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_decode_routes_by_dtype_and_head_dim(cuda):
    """bf16 with d in {64, 128} takes the ring kernel, bf16 with d in
    {16, 32} the cp.async one, float32 the CUDA-core one."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)

    lens = torch.tensor([70], dtype=torch.int32, device=cuda)
    for dt, d, route in ((torch.bfloat16, 128, "bf16_ring"),
                         (torch.bfloat16, 64, "bf16_ring"),
                         (torch.bfloat16, 32, "bf16_mma_sync"),
                         (torch.bfloat16, 16, "bf16_mma_sync"),
                         (torch.float32, 128, "f32")):
        kv = torch.randn(1, 70, 2, d, device=cuda).to(dt)
        q = torch.randn(1, 4, d, device=cuda).to(dt)
        before = dict(decode_attention_cuda.launches_by_route)
        decode_attention_cuda(q, kv, kv, lens, window=30)
        after = decode_attention_cuda.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}


def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    q = torch.zeros(1, 8, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :24].contiguous(), q[..., :24], q[..., :24])
    with pytest.raises(ValueError, match="share"):
        flash_attention_cuda(q, q.half(), q.half())
    spread = torch.zeros(1, 8, 32, 4, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="packed heads"):
        flash_attention_cuda(q, spread, spread)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_attention_cuda(q[:, 0], q, q, lens.long())
    with pytest.raises(ValueError, match="at most 16"):
        decode_attention_cuda(torch.zeros(1, 17, 32, device=cuda),
                              q[:, :, :1], q[:, :, :1], lens)


@pytest.mark.parametrize("arch,dtype,tol", [
    ("starcoder2-7b", "float32", 1e-4),
    ("starcoder2-7b", "bfloat16", 5e-2),
    ("glm4-9b", "bfloat16", 5e-2),
])
def test_reduced_model_on_card_matches_cpu(cuda, arch, dtype, tol):
    """The reduced model's prefill and decode on the card (through the
    kernels) == the same model on the CPU (plain versions), over a prompt
    longer than the reduced window; both kernels were launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.models import (
        decode_step, init_model_params, init_serve_cache, prefill)

    cfg = get_config(arch).reduced().with_overrides(dtype=dtype)
    cpu = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_model_params(cfg, torch.Generator().manual_seed(0),
                             "cpu").to(cuda)
    cdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 90)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        cache = init_serve_cache(cfg, 2, 100, dtype=cdt, device=dev)
        logits, cache = prefill(model, {"tokens": toks, "cache": cache})
        steps = [logits.cpu()]
        for i in range(3):
            logits, cache = decode_step(model, {
                "tokens": nxt[:, i:i + 1], "pos": np.full(2, 90 + i, np.int32),
                "cache": cache})
            steps.append(logits.cpu())
        out.append(steps)
    for a, b in zip(*out):
        torch.testing.assert_close(b[..., :cfg.vocab_size],
                                   a[..., :cfg.vocab_size], rtol=tol,
                                   atol=tol)
    assert flash_attention_cuda.launches == before[0] + cfg.num_layers
    assert decode_attention_cuda.launches == before[1] + 3 * cfg.num_layers


# ---------------------------------------------------------------------------
# async and streamed staging on the card (pinned ring, side-stream copies)
# ---------------------------------------------------------------------------

def _deployed_tiny(tmp_path):
    from repro_torch.gofs import GoFSStore, deploy_collection

    col = generate_collection(TR_TINY)
    t = col.template
    assign = partition_graph(t, TR_TINY.num_partitions, seed=TR_TINY.seed)
    bg = build_blocked(t, assign, TR_TINY.block_size)
    root = str(tmp_path / "gofs")
    deploy_collection(col, TR_TINY, root, assign=assign,
                      sparse_absent={"latency": float("inf")})
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    return col, bg, GoFSStore(root), lat, act


def _same_run(got, want):
    assert np.array_equal(got.values, want.values, equal_nan=True)
    assert np.array_equal(got.final, want.final, equal_nan=True)
    for k in ("supersteps", "local_sweeps"):
        assert np.array_equal(got.stats[k], want.stats[k])


@pytest.mark.parametrize("mode", ["spmv", "fused"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_async_and_streamed_match_sync_on_card(cuda, tmp_path, mode,
                                               layout):
    """An async run (in-memory weights) and a streamed run (a GoFS stream:
    dense, or sparse from the delta chain) on the card equal the sync run
    bitwise, min-plus and plus-mul alike; streamed chunks leave no device
    copy in the engine's staged-batch cache."""
    from repro_torch.gofs.prefetch import pinned_ring

    col, bg, store, lat, act = _deployed_tiny(tmp_path)
    t = col.template
    sssp = T.min_plus_program("sssp", init=T.source_init(0))
    eng = T.TemporalEngine(bg, use_pallas=mode, layout=layout)
    eng_async = T.TemporalEngine(bg, use_pallas=mode, layout=layout,
                                 staging="async", chunk_instances=2)
    eng_stream = T.TemporalEngine(bg, use_pallas=mode)
    for pattern in ("sequential", "independent"):
        want = eng.run(sssp, lat, pattern=pattern)
        _same_run(eng_async.run(sssp, lat, pattern=pattern), want)
        got = eng_stream.run(sssp, pattern=pattern,
                             stream=store.load_blocked_stream(
                                 bg, "latency", layout=layout,
                                 chunk_instances=2))
        _same_run(got, want)
        assert len(eng_stream._staged_device) == 0
        assert len(eng_async._staged_device) == 0
        rep = eng_stream.last_stream_report
        assert rep["compute_clock"] == "cuda events"
        assert rep["chunks"] == 3 and rep["compute_seconds"] > 0
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)
    pr = T.pagerank_program(t.num_vertices, iters=6)
    want = eng.run(pr, prw, pattern="eventually", merge="mean")
    got = eng_async.run(pr, prw, pattern="eventually", merge="mean")
    assert np.array_equal(got.values, want.values)
    assert np.array_equal(got.merged, want.merged)
    assert pinned_ring(cuda).peak_bytes > 0


def test_pinned_buffer_not_rewritten_before_its_copy(cuda, tmp_path):
    """A slow consumer with inflight 1: each chunk's copy is held back on
    the side stream (``torch.cuda._sleep``) after its pinned buffer is
    released.  The producer runs ahead meanwhile, so a buffer refilled
    before its copy's event completed would reach the card with another
    chunk's tiles; every copy must equal the chunk as it was handed over,
    and the ring must stay within window + 2 buffers."""
    from repro_torch.gofs.prefetch import PinnedRing, SlicePrefetcher

    col, bg, store, lat, act = _deployed_tiny(tmp_path)
    w = np.concatenate([lat, lat * 2.0, lat * 3.0])
    pf = SlicePrefetcher.from_weights(bg, w, zero=float("inf"),
                                      chunk_instances=1, prefetch_depth=2,
                                      inflight=1)
    ring = PinnedRing()
    pf.ring = ring
    side = torch.cuda.Stream(cuda)
    try:
        for k, ch in enumerate(pf):
            snap = ch.tiles.copy()
            with torch.cuda.stream(side):
                torch.cuda._sleep(50_000_000)  # the copy starts late
                dev = torch.empty(snap.shape, device=cuda)
                dev.copy_(torch.from_numpy(ch.tiles), non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            ch.release(ev)
            del ch
            ev.synchronize()
            assert np.array_equal(dev.cpu().numpy(), snap), k
            assert len(ring._slots) <= pf.window + 2
    finally:
        ring.close()


def test_session_on_card_matches_cpu(cuda, tmp_path):
    """The session on the card plans its kernel by the auto rule, takes
    fused under an override, and its runs (streamed, sync, the sparse
    delta route) equal the CPU session bitwise; its streams fill pinned
    buffers."""
    from repro_torch.gofs.prefetch import pinned_ring, release_pinned
    from repro_torch.gopher import GopherSession

    col, bg, store, lat, act = _deployed_tiny(tmp_path)
    release_pinned()
    gpu = GopherSession(store, device="cuda")
    cpu = GopherSession(store, device="cpu")
    plan = gpu.plan("sssp", source=0)
    assert plan.kernel.value in ("spmv", "fused")
    assert plan.kernel.source == "auto"
    for kw in (dict(), dict(kernel="fused"), dict(staging="sync"),
               dict(layout="sparse", kernel="fused")):
        got = gpu.run(gpu.plan("sssp", source=0, **kw))
        ckw = {k: v for k, v in kw.items() if k != "kernel"}
        want = cpu.run(cpu.plan("sssp", source=0, **ckw))
        _same_run(got.engine, want.engine)
        assert gpu.last_run_report == cpu.last_run_report
    # the session's streams filled pinned buffers
    assert pinned_ring(cuda).peak_bytes > 0


# --------------------------------------------------------------------------
# the query axis: both kernels in their Q-lane form
# --------------------------------------------------------------------------

def _lanes(rng, sr, P, Q, nvb, B):
    """Q lanes of a (P, nvb, B) state; min-plus lanes with unreached
    blocks."""
    x = rng.random((Q, P, nvb, B)).astype(np.float32)
    if sr is MIN_PLUS:
        x[::2, :, 0] = np.inf
    return x


@pytest.mark.parametrize("B", [32, 64])
@pytest.mark.parametrize("sr", [MIN_PLUS, PLUS_MUL], ids=lambda s: s.name)
@pytest.mark.parametrize("Q", [1, 3, 4, 9, 32])
def test_q_lane_kernels_match_plain(cuda, B, sr, Q):
    """Q lanes in one launch of each kernel against the plain version:
    the local sweep (x per partition), the consume (one boundary shared by
    partitions, not by lanes) on skewed runs, the vote per (lane,
    partition); and each lane bitwise equal to the kernel's own rank-2
    call on that lane (one fold order whatever Q is)."""
    tiles, rows, brows, cols, _, xb1, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            sr, np.random.default_rng(10 + Q), B=B)]
    P, _, _, _ = tiles.shape
    nvb, nbb = vm.shape[1], xb1.shape[1]
    rng = np.random.default_rng(Q)
    x = torch.as_tensor(_lanes(rng, sr, P, Q, nvb, B), device=cuda)
    xb = torch.as_tensor(_lanes(rng, sr, 1, Q, nbb, B), device=cuda)
    x_ref = x.flip(3).contiguous()
    n0 = (spmv_blocked_cuda.launches, fused_step_cuda.launches)
    for r, xin, ref in ((rows, x, x), (brows, xb, x_ref)):
        flat = xin.reshape(Q, xin.shape[1], -1)
        k = spmv_blocked_cuda(tiles, r, cols, flat, sr, n_out_blocks=nvb)
        assert k.shape == (Q, P, nvb * B)
        _agree(k, spmv_blocked_ref(tiles, r, cols, flat, sr,
                                   n_out_blocks=nvb), sr)
        ko, kc = fused_step_cuda(tiles, r, cols, xin, x, ref, vm, sr)
        po, pc = fused_step_ref(tiles, r, cols, xin, x, ref, vm, sr)
        _agree(ko, po, sr)
        assert kc.shape == (Q, P, 1) and torch.equal(kc, pc)
        for q in range(Q):
            assert torch.equal(k[q], spmv_blocked_cuda(
                tiles, r, cols, flat[q], sr, n_out_blocks=nvb))
            oq, cq = fused_step_cuda(tiles, r, cols, xin[q], x[q], ref[q],
                                     vm, sr)
            assert torch.equal(ko[q], oq) and torch.equal(kc[q], cq)
    # one launch per call, whatever Q is (the per-lane calls add 2 Q each)
    assert spmv_blocked_cuda.launches - n0[0] == 2 + 2 * Q
    assert fused_step_cuda.launches - n0[1] == 2 + 2 * Q


@pytest.mark.parametrize("sr", [MIN_PLUS, PLUS_MUL], ids=lambda s: s.name)
def test_q_lane_kernels_take_a_lane_stride(cuda, sr):
    """x with a lane stride that is not the lane's size (a slice of a wider
    buffer) and a shared boundary whose lane stride is its own length:
    both kernels read each lane where its stride puts it."""
    tiles, rows, brows, cols, _, xb1, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            sr, np.random.default_rng(21))]
    P, _, B, _ = tiles.shape
    nvb, nbb, Q = vm.shape[1], xb1.shape[1], 6
    rng = np.random.default_rng(22)
    wide = torch.as_tensor(_lanes(rng, sr, P + 2, Q, nvb, B), device=cuda)
    x = wide[:, 1:P + 1]  # lane stride (P + 2) * nvb * B, offset one
    assert not x.is_contiguous()
    flat = x.reshape(Q, P, -1)
    k = spmv_blocked_cuda(tiles, rows, cols, flat, sr, n_out_blocks=nvb)
    _agree(k, spmv_blocked_ref(tiles, rows, cols, flat.contiguous(), sr,
                               n_out_blocks=nvb), sr)
    bnd = torch.as_tensor(_lanes(rng, sr, 1, Q, nbb + 1, B), device=cuda)
    b = bnd[:, :, 1:]  # shared by partitions, lanes (nbb + 1) * B apart
    xs = x.contiguous()
    ko, kc = fused_step_cuda(tiles, brows, cols, b, xs, xs.flip(3).
                             contiguous(), vm, sr)
    po, pc = fused_step_ref(tiles, brows, cols, b.contiguous(), xs,
                            xs.flip(3).contiguous(), vm, sr)
    _agree(ko, po, sr)
    assert torch.equal(kc, pc)
    # a state that starts 4 bytes off: contiguous, but no lane is aligned
    off = torch.empty(xs.numel() + 1, device=cuda)[1:].view(xs.shape)
    off.copy_(xs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_step_cuda(tiles, rows, cols, xs, off, None, None, sr)


def test_q_lane_graph_replay_is_bitwise(cuda):
    """Q-lane launches captured in one CUDA graph and replayed give the
    eager outputs; the run tickets reset themselves."""
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    tiles, rows, brows, cols, _, xb1, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(
            PLUS_MUL, np.random.default_rng(23))]
    P, _, B, _ = tiles.shape
    nvb, nbb, Q = vm.shape[1], xb1.shape[1], 9
    rng = np.random.default_rng(24)
    x = torch.as_tensor(_lanes(rng, PLUS_MUL, P, Q, nvb, B), device=cuda)
    xb = torch.as_tensor(_lanes(rng, PLUS_MUL, 1, Q, nbb, B), device=cuda)
    plan = to_device(walk_plan(cols.cpu().numpy(), nvb,
                               chunk=default_chunk(B)), cuda)

    def call():
        return (spmv_blocked_cuda(tiles, brows, cols, xb.reshape(Q, 1, -1),
                                  PLUS_MUL, n_out_blocks=nvb, plan=plan),
                *fused_step_cuda(tiles, brows, cols, xb, x, x + 1, vm,
                                 PLUS_MUL, plan=plan))

    eager = call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for _ in range(10):
            outs.append(call())
    g.replay()
    torch.cuda.synchronize()
    for out in outs:
        for got, want in zip(out, eager):
            assert torch.equal(got, want)
    assert int(plan.counters.abs().sum()) == 0


@pytest.mark.parametrize("mode", ["spmv", "fused"])
def test_query_axis_on_card_matches_cpu(cuda, mode):
    """TR_TINY with 9 sources on the card, lanes halting at different
    supersteps (and some stopped by a cap): equal to the CPU run and to
    each source's own run on the card, bitwise; the sweeps take one
    launch for all lanes."""
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions),
                       TR_TINY.block_size)
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    srcs = [0, 3, 9, 31, 64, 101, 200, 333, 511]
    for cap in (64, 5):
        prog = T.min_plus_program("sssp", init=T.sources_init(srcs),
                                  max_supersteps=cap)
        want = T.TemporalEngine(bg, device="cpu").run(
            prog, lat, pattern="sequential")
        ss = want.stats["supersteps"]
        assert len(np.unique(ss)) > 1  # lanes halt at different supersteps
        eng = T.TemporalEngine(bg, use_pallas=mode)
        n0 = spmv_blocked_cuda.launches + fused_step_cuda.launches
        got = eng.run(prog, lat, pattern="sequential")
        n = spmv_blocked_cuda.launches + fused_step_cuda.launches - n0
        _same_run(got, want)
        # a launch per sweep and per consume of the batched run, for all
        # lanes: at least the slowest lane's count, far under the sum
        per_lane = ss + want.stats["local_sweeps"]
        assert per_lane.max(0).sum() <= n < per_lane.sum()
        for q, s in enumerate(srcs):
            one = eng.run(T.min_plus_program(
                "sssp", init=T.source_init(s), max_supersteps=cap), lat,
                pattern="sequential")
            assert np.array_equal(got.values[q], one.values)
            for k in ("supersteps", "local_sweeps"):
                assert np.array_equal(got.stats[k][q], one.stats[k])


# --------------------------------------------------------------------------
# the min-plus lane walk (one walk of each chunk for every lane) and the
# signed zeros of the min
# --------------------------------------------------------------------------

def _same_bits(got, want):
    """Min-plus outputs: NaN where the plain version has NaN, every other
    entry bit for bit (-0 is not +0).  NaN payloads are not compared: the
    kernel's min.NaN gives the canonical NaN where torch.minimum passes an
    input NaN through."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _special_lanes(rng, Q, shape):
    """Q min-plus lanes of ``shape`` holding ±0, ±inf and NaN among
    positive values: lane q % 4 == 1 all signed zeros, == 2 with NaN at a
    few rows, == 3 with -inf at a few rows."""
    x = rng.random((Q,) + shape).astype(np.float32)
    x[::2, ..., 0] = np.inf
    x[1::4] = rng.choice(np.array([0.0, -0.0], np.float32),
                         x[1::4].shape)
    x[2::4, ..., 3] = np.nan
    x[3::4, ..., 5] = -np.inf
    return x


def _special_tiles(tiles, rng):
    """The skewed structure's tiles with ±0 in place of a third of the
    weights, and a -inf and a NaN weight in partition 1."""
    t = tiles.copy()
    live = np.isfinite(t) & (rng.random(t.shape) < 0.33)
    t[live] = rng.choice(np.array([0.0, -0.0], np.float32), int(live.sum()))
    t[1, 10, 3, 4], t[1, 20, 5, 6] = -np.inf, np.nan
    return t


@pytest.mark.parametrize("B", [32, 64, 128])
@pytest.mark.parametrize("Q", [5, 8, 20, 32, 33])
def test_lane_walk_matches_plain(cuda, B, Q):
    """The min-plus lane walk of both kernels against the plain version on
    skewed runs (one run of 225 tiles, runs of 1..200), with ±0, ±inf and
    NaN in the states and the weights: the local sweep (x per partition),
    the consume (one boundary shared by partitions) with the combine and
    the vote; each lane bitwise equal to the one-lane kernel's call on
    that lane; every Q-lane launch on the lane walk."""
    from repro_torch.kernels.walk_plan import default_chunk, lane_walk

    rng = np.random.default_rng(100 * B + Q)
    tiles, rows, brows, cols, _, xb1, vm = _skewed(MIN_PLUS, rng, B=B)
    tiles = _special_tiles(tiles, rng)
    P, nvb, nbb = tiles.shape[0], vm.shape[1], xb1.shape[1]
    x = _special_lanes(rng, Q, (P, nvb, B))
    xb = _special_lanes(rng, Q, (1, nbb, B))
    tiles, rows, brows, cols, vm, x, xb = [
        torch.as_tensor(a, device=cuda) for a in (
            tiles, rows, brows, cols, vm, x, xb)]
    x_ref = x.flip(3).contiguous()
    assert lane_walk(Q, B, default_chunk(B)) is not None
    n0 = dict(spmv_blocked_cuda.launches_by_walk)
    f0 = dict(fused_step_cuda.launches_by_walk)
    for r, xin, ref in ((rows, x, x), (brows, xb, x_ref)):
        flat = xin.reshape(Q, xin.shape[1], -1)
        k = spmv_blocked_cuda(tiles, r, cols, flat, MIN_PLUS,
                              n_out_blocks=nvb)
        _same_bits(k, spmv_blocked_ref(tiles, r, cols, flat, MIN_PLUS,
                                       n_out_blocks=nvb))
        ko, kc = fused_step_cuda(tiles, r, cols, xin, x, ref, vm, MIN_PLUS)
        po, pc = fused_step_ref(tiles, r, cols, xin, x, ref, vm, MIN_PLUS)
        _same_bits(ko, po)
        assert torch.equal(kc, pc)
        for q in range(Q):
            assert torch.equal(k[q].view(torch.int32), spmv_blocked_cuda(
                tiles, r, cols, flat[q], MIN_PLUS,
                n_out_blocks=nvb).view(torch.int32))
            oq, cq = fused_step_cuda(tiles, r, cols, xin[q], x[q], ref[q],
                                     vm, MIN_PLUS)
            assert torch.equal(ko[q].view(torch.int32),
                               oq.view(torch.int32))
            assert torch.equal(kc[q], cq)
    assert spmv_blocked_cuda.launches_by_walk["lane_walk"] - \
        n0["lane_walk"] == 2
    assert fused_step_cuda.launches_by_walk["lane_walk"] - \
        f0["lane_walk"] == 2


@pytest.mark.parametrize("Q", [1, 4, 8, 32])
@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
def test_min_orders_signed_zeros_on_card(cuda, Q, reverse):
    """The two-tile control: one output block, two tiles, x = -0 at both
    tiles' rows, weights +0 in one tile and -0 in the other.  Every walk
    (one lane, groups of 4, the lane walk) gives -0 at every output in
    both tile orders, as the plain version and jnp.min do; chunks of one
    tile make the two meet in the run's combine, and the fused combine
    with x_comb = +0 keeps -0."""
    from repro_torch.kernels.walk_plan import to_device, walk_plan

    B = 64
    tiles = np.stack([np.full((B, B), 0.0, np.float32),
                      np.full((B, B), -0.0, np.float32)])[None]
    rows = np.array([[0, 1]], np.int32)
    if reverse:
        tiles, rows = tiles[:, ::-1].copy(), rows[:, ::-1].copy()
    cols = np.zeros((1, 2), np.int32)
    x = np.full((Q, 1, 2, B), -0.0, np.float32)
    t, r, c, xs = [torch.as_tensor(a, device=cuda)
                   for a in (tiles, rows, cols, x)]
    for chunk in (1, 2):
        plan = to_device(walk_plan(cols, 1, chunk=chunk), cuda)
        k = spmv_blocked_cuda(t, r, c, xs.reshape(Q, 1, -1), MIN_PLUS,
                              n_out_blocks=1, plan=plan)
        assert bool(torch.signbit(k).all()) and bool((k == 0).all())
        comb = torch.zeros((Q, 1, 1, B), device=cuda)
        ko, _ = fused_step_cuda(t, r, c, xs, comb, None, None, MIN_PLUS,
                                plan=plan)
        assert bool(torch.signbit(ko).all()) and bool((ko == 0).all())
        po, _ = fused_step_ref(t, r, c, xs, comb, None, None, MIN_PLUS)
        _same_bits(ko, po)


def test_min_plus_folds_on_card(cuda):
    """MIN_PLUS's folds on CUDA tensors order -0 below +0 in every order
    and give NaN for a NaN operand, as on the CPU (where
    tests/test_torch_signed_zero.py holds them against jnp): ``add``
    (torch's own CUDA minimum), ``add_reduce``, ``segment_reduce`` and
    ``scatter_add`` (torch's CUDA amin and scatter_reduce keep whichever
    zero comes first; the repair makes the sign right)."""
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5],
                    np.float32)
    a, b = (np.array(v, np.float32) for v in zip(
        *[(x, y) for x in vals for y in vals]))
    ta, tb = torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)
    _same_bits(MIN_PLUS.add(ta, tb).cpu(),
               MIN_PLUS.add(ta.cpu(), tb.cpu()))
    for n in (2, 33, 100000):
        x = torch.zeros(n, device=cuda)
        x[n // 2:] = -0.0
        for t in (x, x.flip(0)):
            assert bool(torch.signbit(MIN_PLUS.add_reduce(t, 0)))
            assert bool(torch.signbit(MIN_PLUS.segment_reduce(
                t, torch.zeros(n, dtype=torch.long, device=cuda), 1)[0]))
            y = torch.full((1,), np.inf, device=cuda)
            assert bool(torch.signbit(MIN_PLUS.scatter_add(
                y, torch.zeros(n, dtype=torch.long, device=cuda), t)[0]))
    assert bool(torch.isnan(MIN_PLUS.add(torch.tensor([np.nan], device=cuda),
                                         torch.zeros(1, device=cuda))))


def test_lane_walk_graph_replay_is_bitwise(cuda):
    """Lane-walk launches (Q = 20 and 33, two passes) captured in one CUDA
    graph and replayed give the eager outputs; the run tickets reset
    themselves."""
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    rng = np.random.default_rng(31)
    tiles, rows, brows, cols, _, xb1, vm = [
        torch.as_tensor(a, device=cuda) for a in _skewed(MIN_PLUS, rng)]
    P, _, B, _ = tiles.shape
    nvb, nbb = vm.shape[1], xb1.shape[1]
    plan = to_device(walk_plan(cols.cpu().numpy(), nvb,
                               chunk=default_chunk(B)), cuda)
    ins = []
    for Q in (20, 33):
        x = torch.as_tensor(_special_lanes(rng, Q, (P, nvb, B)), device=cuda)
        xb = torch.as_tensor(_special_lanes(rng, Q, (1, nbb, B)),
                             device=cuda)
        ins.append((x, xb))

    def call():
        out = []
        for x, xb in ins:
            Q = x.shape[0]
            out.append(spmv_blocked_cuda(tiles, brows, cols,
                                         xb.reshape(Q, 1, -1), MIN_PLUS,
                                         n_out_blocks=nvb, plan=plan))
            out.extend(fused_step_cuda(tiles, brows, cols, xb, x,
                                       x.flip(3).contiguous(), vm, MIN_PLUS,
                                       plan=plan))
        return out

    eager = call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for _ in range(10):
            outs.append(call())
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for out in outs:
            for got, want in zip(out, eager):
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
    assert int(plan.counters.abs().sum()) == 0


def test_walk_argument_is_checked(cuda):
    """The C entry points refuse a launch whose walk is not the rule's:
    the group walk for a min-plus call of 32 lanes, the lane walk for a
    plus-mul call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.walk_plan import kernel_plan

    rng = np.random.default_rng(41)
    tiles, rows, _, cols, x, _, _ = [
        torch.as_tensor(a, device=cuda) for a in _skewed(MIN_PLUS, rng)]
    P, T_, B, _ = tiles.shape
    Q, nvb = 32, x.shape[1]
    xq = x.reshape(1, P, -1).expand(Q, -1, -1).contiguous()
    y = torch.empty((Q, P, nvb * B), device=cuda)

    def need(cond, msg):
        assert cond, msg

    plan, partials = kernel_plan(None, cols, nvb, None, B, need, Q,
                                 "lane_walk")
    lib = _build.library()
    for sr, walk in (("min_plus", 0), ("plus_mul", 1)):
        code = lib.spmv_blocked_f32(
            tiles.data_ptr(), rows.data_ptr(), xq.data_ptr(),
            plan.chunks.data_ptr(), plan.first.data_ptr(),
            plan.count.data_ptr(), plan.counters.data_ptr(),
            partials.data_ptr(), y.data_ptr(), T_, B, plan.chunks.shape[0],
            plan.chunk, P, Q, xq.stride(0), xq.stride(1), nvb,
            _build.SEMIRING_CODES[sr], walk,
            torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="invalid argument"):
            _build.check(code, "spmv_blocked_cuda")


# ---------------------------------------------------------------------------
# streaming ingestion and warm serving on the card
# ---------------------------------------------------------------------------

WAIT = 300  # seconds: the longest a card test waits on a service


def _growing_tiny(tmp_path, n0=3):
    """TR_TINY deployed up to ``n0`` instances (latency tile maps and the
    delta chain), and a function appending instances [lo, hi)."""
    from repro_torch.core.graph import TimeSeriesGraph
    from repro_torch.gofs import append_instances, deploy_collection

    col = generate_collection(TR_TINY)
    root = str(tmp_path / "live")

    def part(lo, hi):
        return TimeSeriesGraph(template=col.template,
                               instances=col.instances[lo:hi])

    deploy_collection(part(0, n0), TR_TINY, root,
                      sparse_absent={"latency": float("inf")})
    return root, lambda lo, hi: append_instances(part(lo, hi), root)


def test_tail_on_card_matches_cpu(cuda, tmp_path):
    """``tail`` on the card (spmv and fused; one source and five, which
    take the lane walk) equals the CPU session's tail bitwise, update by
    update over two appends (the second rewrites the tail pack)."""
    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession

    root, append = _growing_tiny(tmp_path)
    sessions = [GopherSession(GoFSStore(root), device=d, use_pallas=m)
                for d, m in (("cuda", "spmv"), ("cuda", "fused"),
                             ("cpu", None))]
    asks = [dict(source=0), dict(source=[0, 7, 11, 20, 33]),
            dict(source=3, pattern="independent", warm=True)]
    for lo, hi in ((None, None), (3, 4), (4, 6)):
        if lo is not None:
            append(lo, hi)
        for kw in asks:
            *gpu, cpu = [s.tail("sssp", **kw) for s in sessions]
            for u in gpu:
                assert (u.mode, u.new_instances, u.version) == \
                    (cpu.mode, cpu.new_instances, cpu.version)
                _same_run(u.result.engine, cpu.result.engine)
    assert cpu.mode == "incremental" and cpu.result.engine.values.shape[
        -2] == 6


def test_service_on_card_matches_cpu(cuda, tmp_path):
    """The service on the card answers a 32-source SSSP batch and an N-hop
    group as the CPU service does, bitwise, and its subscription's updates
    over an append equal the CPU's.  Its loop thread runs on the session's
    device and on the stream that was current where the service started;
    a streamed run driven from that thread fills pinned buffers."""
    import threading

    from repro_torch.gofs import GoFSStore
    from repro_torch.gofs.prefetch import pinned_ring, release_pinned
    from repro_torch.gopher import GopherService, GopherSession

    root, append = _growing_tiny(tmp_path)
    side = torch.cuda.Stream(cuda)
    seen = []

    def on_update(u):  # runs on the serve thread
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device(),
                     torch.cuda.current_stream() == side))
        if len(seen) == 1:  # a streamed run from the loop thread
            release_pinned()
            s = GopherSession(GoFSStore(root), device="cuda")
            r = s.run(s.plan("sssp", source=0, staging="async"))
            seen.append(("streamed", r.engine, pinned_ring(cuda).peak_bytes))

    srcs = [int(v) for v in np.random.default_rng(0).choice(
        TR_TINY.num_vertices, 32, replace=False)]
    reqs = [("sssp", {"source": v}) for v in srcs] + \
        [("nhop", {"source": v, "n_hops": 3}) for v in srcs[:4]]
    with torch.cuda.stream(side):
        gpu = GopherService(GoFSStore(root), device="cuda",
                            max_batch_queries=36, poll_interval=0.01).start()
    cpu = GopherService(GoFSStore(root), device="cpu",
                        max_batch_queries=36, poll_interval=0.01).start()
    try:
        subs = [gpu.subscribe("sssp", source=0, callback=on_update),
                cpu.subscribe("sssp", source=0)]
        firsts = [s.wait_update(1, timeout=WAIT) for s in subs]
        outs = [[t.wait(WAIT) for t in svc.submit_many(reqs)]
                for svc in (gpu, cpu)]
        append(3, 5)
        seconds = [s.wait_update(2, timeout=WAIT) for s in subs]
        reps = [svc.report() for svc in (gpu, cpu)]
    finally:
        gpu.stop()
        cpu.stop()
    for a, b in zip(*outs):
        for k, v in b.output.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(a.output[k], v, equal_nan=True), k
    _same_run(outs[0][0].engine, outs[1][0].engine)
    for a, b in (firsts, seconds):
        assert (a.mode, a.new_instances) == (b.mode, b.new_instances)
        _same_run(a.result.engine, b.result.engine)
    assert seconds[0].mode == "incremental"
    assert reps[0]["batches"] == reps[1]["batches"] == 1
    assert reps[0]["staging_cache"] == reps[1]["staging_cache"]
    loop = [x for x in seen if x[0] == "gopher-serve"]
    assert len(loop) == 2
    assert all(dev == torch.cuda.current_device() and on_side
               for _, dev, on_side in loop)
    _, streamed, pinned = next(x for x in seen if x[0] == "streamed")
    _same_run(streamed, firsts[1].result.engine)
    assert pinned > 0


# --------------------------------------------------------------------------
# the cluster runtime on the card: two in-thread shards share the device
# --------------------------------------------------------------------------

# tests/conftest.py's TINY (3 partitions: shards of 2 and 1)
TINY = GraphConfig(
    name="tiny", num_vertices=300, avg_degree=3.0, num_instances=3,
    num_partitions=3, block_size=32, instances_per_slice=2,
    bins_per_partition=2, cache_slots=4, seed=11,
)


def _two_runtimes(fn, n=2, timeout=300.0):
    """``fn(runtime)`` on ``n`` in-thread peers of one TCP exchange;
    returns their results in process-id order."""
    import socket
    import threading

    from repro_torch.cluster.runtime import ClusterRuntime, TcpExchange

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out, errs = [None] * n, [None] * n

    def peer(pid):
        try:
            ex = TcpExchange.listen(port, n, host="127.0.0.1",
                                    timeout=timeout) if pid == 0 else \
                TcpExchange.connect("127.0.0.1", port, pid, n,
                                    timeout=timeout)
            with ClusterRuntime(pid, n, exchange=ex) as rt:
                out[pid] = fn(rt)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs[pid] = e

    ts = [threading.Thread(target=peer, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    for e in errs:
        if e is not None:
            raise e
    return out


@pytest.mark.parametrize("cfg", [TINY, TR_TINY], ids=lambda c: c.name)
@pytest.mark.parametrize("mode", ["spmv", "fused"])
def test_cluster_shards_on_card_match_one_process(cuda, cfg, mode):
    """Two cluster shards on the card (P_local of 1-2) == one process on
    the card in the same kernel mode: SSSP (sequential) and PageRank
    (independent) bitwise in values, final and supersteps; the mode's
    kernel was launched at the shards' call shapes."""
    col = generate_collection(cfg)
    t = col.template
    bg = build_blocked(t, partition_graph(t, cfg.num_partitions,
                                          seed=cfg.seed), cfg.block_size)
    lat = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    act = np.stack([col.edge_values(i, "active") for i in range(len(col))])
    prw = edge_weights_for_instances(t.src, act, t.num_vertices)
    sssp = T.min_plus_program("sssp", init=T.source_init(0))
    pr = T.pagerank_program(t.num_vertices, iters=6)
    one = T.TemporalEngine(bg, use_pallas=mode)
    want = [one.run(sssp, lat, pattern="sequential"),
            one.run(pr, prw, pattern="independent")]
    kernel = spmv_blocked_cuda if mode == "spmv" else fused_step_cuda
    before = kernel.launches

    def shard(rt):
        eng = T.TemporalEngine(bg, use_pallas=mode, cluster=rt)
        assert eng._index[0].shape[0] == \
            rt.partition_shard(bg.n_parts)[1] \
            - rt.partition_shard(bg.n_parts)[0]
        return [eng.run(sssp, lat, pattern="sequential"),
                eng.run(pr, prw, pattern="independent")]

    for got in _two_runtimes(shard):
        for g, w in zip(got, want):
            for a, b in ((g.values, w.values), (g.final, w.final),
                         (g.stats["supersteps"], w.stats["supersteps"])):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    assert kernel.launches > before


def test_cluster_sessions_on_card_stage_pinned_shards(cuda, tmp_path):
    """Two cluster sessions on the card over one deployment: each streams
    its shard through ``shard_stream`` into the pinned ring (``bind``
    reaches the prefetcher), stages fewer bytes than one process, and
    SSSP and PageRank equal one process's bitwise."""
    from repro_torch.gofs.prefetch import pinned_ring, release_pinned
    from repro_torch.gopher import GopherSession

    _col, _bg, store, _lat, _act = _deployed_tiny(tmp_path)
    one = GopherSession(store)
    plans = [one.plan("sssp", source=0), one.plan("pagerank", iters=6)]
    want = [one.run(p) for p in plans]
    single = [one.run_many([p]) and one.last_run_report["staged_bytes"]
              for p in plans]
    # a fresh ring: the buffers the single-process runs pinned are kept
    # and could serve the shards' smaller chunks with no new pin, leaving
    # peak_bytes at 0 whether or not the shards went through the ring
    release_pinned()
    ring = pinned_ring(cuda)

    def shard(rt):
        sess = GopherSession(store, cluster=rt)
        out = []
        for p in plans:
            res = sess.run(sess.plan(p.analytic, **p.param_dict))
            out.append((res, sess.last_run_report["staged_bytes"]))
        return out

    for got in _two_runtimes(shard):
        for (res, staged), w, full in zip(got, want, single):
            assert staged < full
            for a, b in ((res.engine.values, w.engine.values),
                         (res.engine.final, w.engine.final),
                         (res.engine.stats["supersteps"],
                          w.engine.stats["supersteps"])):
                assert a.tobytes() == b.tobytes()
    assert ring.peak_bytes > 0


# ---------------------------------------------------------------------------
# the mesh (multi-GPU placement) on the one card
# ---------------------------------------------------------------------------

MESH_CFG = GraphConfig(name="t", num_vertices=500, avg_degree=3.0,
                       num_instances=4, num_partitions=4, block_size=32,
                       seed=7)


def _mesh_on_card(tmp_path, data, model, backend):
    """Run the mesh worker's ``card`` case in data x model rank processes
    on the card (tests/torch_mesh_worker.py); every rank's results."""
    import json
    import os
    import pickle
    import subprocess
    import sys

    from repro_torch.kernels import _build

    _build.library()  # built once here; the ranks load it
    col = generate_collection(MESH_CFG)
    t = col.template
    bg = build_blocked(t, partition_graph(t, 4, seed=7), 32)
    lat = np.stack([col.edge_values(i, "latency") for i in range(4)])
    act = np.stack([col.edge_values(i, "active") for i in range(4)])
    inputs = dict(bg=bg, lat=lat, prw=edge_weights_for_instances(
        t.src, act, t.num_vertices), zero_sources=[0])
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    world, procs, outs = data * model, [], []
    for r in range(world):
        outs.append(str(tmp_path / f"rank{r}.pkl"))
        spec = dict(rank=r, world=world, data=data, model=model,
                    init=f"file://{tmp_path / 'rdv'}", device="cuda",
                    backend=backend, inputs=str(tmp_path / "inputs.pkl"),
                    out=outs[-1], cases=["card"], timeout=120)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests",
                                          "torch_mesh_worker.py"),
             json.dumps(spec)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    got = []
    for o in outs:
        with open(o, "rb") as f:
            res = pickle.load(f)["card"]
        assert "error" not in res, res["error"]
        got.append(res)
    return inputs, got


@pytest.mark.parametrize("data,model,backend", [(1, 1, "nccl"),
                                                (1, 2, "gloo")],
                         ids=["nccl_1x1", "gloo_1x2"])
def test_mesh_on_card_matches_the_stacked_engine(cuda, tmp_path, data,
                                                 model, backend):
    """A (1, 1) NCCL mesh and a model = 2 gloo mesh (NCCL refuses two
    ranks on one device) on the card: min-plus bitwise the stacked
    engine's on the card under every comm and both kernel modes (Q = 1
    and Q = 4), PageRank within the kernels' tolerance, and a combine
    that drops the peer's partial must differ (model = 2)."""
    inputs, ranks = _mesh_on_card(tmp_path, data, model, backend)
    bg, lat = inputs["bg"], inputs["lat"]
    seq = T.TemporalEngine(bg).run(
        T.min_plus_program("sssp", init=T.source_init(0)), lat,
        pattern="sequential")
    query = T.TemporalEngine(bg).run(
        T.min_plus_program("sssp", init=T.sources_init([0, 7, 42, 99])),
        lat, pattern="independent")
    pr = T.TemporalEngine(bg).run(
        T.pagerank_program(bg.part_of.shape[0], iters=10), inputs["prw"],
        pattern="independent")
    for got in ranks:
        for comm in ("dense", "ring", "ring-rs"):
            for key, want in ((f"{comm}/spmv", seq), (f"{comm}/fused", seq),
                              (f"{comm}/query", query)):
                g = got[key]
                for f in ("values", "final"):
                    assert g[f].tobytes() == getattr(want, f).tobytes(), key
                for f in ("supersteps", "local_sweeps"):
                    assert np.array_equal(g[f], want.stats[f]), key
        np.testing.assert_allclose(got["pagerank"]["values"], pr.values,
                                   rtol=TOL, atol=TOL)
        differs = got["control"]["values"].tobytes() != seq.values.tobytes()
        assert differs == (model > 1)
