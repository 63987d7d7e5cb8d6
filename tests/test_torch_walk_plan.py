"""The graph kernels' walk plan (``repro_torch.kernels.walk_plan``).

* :func:`walk_plan` (numpy) against a brute force: every walked tile is
  covered exactly once, in order, by chunks of at most ``chunk`` tiles and
  of about equal size; an empty run gets one empty chunk; ``nnz`` caps the
  walk; :func:`walk_plan_torch` gives the same rows.  Over B in {8, 16, 64}
  and a dense (template) and a sparse (packed) index of a small graph,
  plus skewed hand-made structures.
* :func:`fold_by_plan`, the plain fold that follows a plan as the CUDA
  kernels do (chunk partials, then each run's partials in chunk order),
  against ``spmv_blocked_ref`` and against the JAX package's
  ``spmv_blocked`` and ``fused_step`` (Pallas in interpret mode, as
  ``tests/test_torch_kernels.py`` runs them): min-plus bitwise, plus-mul
  within 2e-5 (``tests/test_kernels.py:46``).  A plan with one chunk
  dropped must fail that comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.core.semiring import PLUS_MUL as J_PLUS_MUL
from repro.kernels.semiring_spmm.ops import spmv_blocked as j_spmv
from repro.kernels.semiring_superstep.ops import fused_step as j_fused
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import INF, MIN_PLUS, PLUS_MUL
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
from repro_torch.kernels.walk_plan import (
    WalkPlan, default_chunk, fold_by_plan, kernel_plan, stack_plans,
    to_device, walk_plan, walk_plan_torch)

SR = {"min_plus": (MIN_PLUS, J_MIN_PLUS), "plus_mul": (PLUS_MUL, J_PLUS_MUL)}
TOL = 2e-5  # tests/test_kernels.py:46


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


def _check_plan(plan: WalkPlan, cols, n_out, nnz=None):
    """``plan`` against a brute force over ``cols`` (P, T)."""
    P, T = cols.shape
    chunk = plan.chunk
    assert plan.run_ptr.shape == (P, n_out + 1)
    assert plan.first.shape == plan.count.shape == (P, n_out)
    rows = [tuple(r) for r in np.asarray(plan.chunks)]
    assert [r[:2] for r in rows] == sorted(r[:2] for r in rows)
    for p in range(P):
        n = T if nnz is None else min(T, int(np.reshape(nnz, -1)[
            p if np.size(nnz) > 1 else 0]))
        walked = [t for t in range(n) if 0 <= cols[p, t] < n_out]
        for c in range(n_out):
            run = [t for t in walked if cols[p, t] == c]
            lo, hi = plan.run_ptr[p, c], plan.run_ptr[p, c + 1]
            assert run == list(range(lo, hi))  # one contiguous run
            f, k = plan.first[p, c], plan.count[p, c]
            mine = rows[f:f + k]
            assert all(r[:2] == (p, c) for r in mine)
            assert sum(r[:2] == (p, c) for r in rows) == k
            covered = [t for r in mine for t in range(r[2], r[3])]
            assert covered == run  # each tile once, in order
            sizes = [r[3] - r[2] for r in mine]
            if not run:
                assert sizes == [0]  # an empty run: one empty chunk
            else:
                assert max(sizes) <= chunk and min(sizes) >= 1
                assert max(sizes) - min(sizes) <= 1  # about equal
                assert k == -(-len(run) // chunk)
    assert len(rows) == int(np.sum(plan.count))


def _check_device_plan(plan: WalkPlan, cols, n_out, nnz=None):
    tp = walk_plan_torch(torch.from_numpy(cols), n_out, chunk=plan.chunk,
                         nnz=None if nnz is None else torch.as_tensor(
                             np.broadcast_to(nnz, (cols.shape[0],)).copy(),
                             dtype=torch.int32))
    W = len(plan.chunks)
    P, T = cols.shape
    assert tp.chunks.shape == (P * n_out + P * (T // plan.chunk), 4)
    assert np.array_equal(tp.chunks[:W].numpy(), plan.chunks)
    assert bool((tp.chunks[W:] == -1).all())
    for f in ("run_ptr", "first", "count"):
        assert np.array_equal(getattr(tp, f).numpy(), getattr(plan, f)), f
    assert torch.equal(tp.counters, torch.zeros(P, n_out, dtype=torch.int32))


@pytest.fixture(scope="module", params=[8, 16, 64])
def tiny_graph(request):
    B = request.param
    col = generate_collection(TR_TINY)
    t = col.template
    assign = partition_graph(t, TR_TINY.num_partitions, seed=TR_TINY.seed)
    bg = build_blocked(t, assign, B)
    w = np.stack([col.edge_values(i, "latency") for i in range(len(col))])
    return bg, w


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_walk_plan_matches_brute_force(tiny_graph, layout):
    bg, w = tiny_graph
    n_out = bg.vp // bg.block_size
    if layout == "dense":
        indexes = [(bg.tiles_rc[:, :, 1], None), (bg.btiles_rc[:, :, 1], None)]
    else:
        # a sparse batch of two instances, some tiles switched off
        w = w[:2].copy()
        w[:, ::3] = INF
        sp = bg.stage_sparse(w, INF)
        indexes = [(sp.cols[i], sp.nnz[i]) for i in range(2)] + \
            [(sp.bcols[i], sp.bnnz[i]) for i in range(2)]
    for cols, nnz in indexes:
        for chunk in (default_chunk(bg.block_size), 1, 3):
            plan = walk_plan(cols, n_out, nnz=nnz, chunk=chunk)
            _check_plan(plan, cols, n_out, nnz)
            _check_device_plan(plan, cols, n_out, nnz)


def _skewed_cols(P=4, n_out=6):
    """Partition 0: one output block holding every tile; partition 1: runs
    of 1, 7, 8, 9 and 200 tiles; partition 2: all padding; partition 3:
    every block empty but one, padding after it."""
    T = 225
    cols = np.full((P, T), -1, np.int32)
    cols[0, :] = 4
    cols[1, :] = np.repeat([0, 1, 2, 3, 5], [1, 7, 8, 9, 200])
    cols[3, :30] = 2
    return cols, n_out


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_walk_plan_skewed_runs(chunk):
    cols, n_out = _skewed_cols()
    plan = walk_plan(cols, n_out, chunk=chunk)
    _check_plan(plan, cols, n_out)
    _check_device_plan(plan, cols, n_out)
    # the 200-tile run is cut into equal chunks of at most ``chunk``
    assert plan.count[1, 5] == -(-200 // chunk)
    # the all-padding partition: one empty chunk per block
    assert plan.count[2].tolist() == [1] * n_out
    assert all(r[2] == r[3] for r in plan.chunks[plan.first[2, 0]:
                                                 plan.first[2, 0] + n_out])


@pytest.mark.parametrize("nnz", [0, 5, 17, 224])
def test_walk_plan_nnz_cap(nnz):
    cols, n_out = _skewed_cols()
    caps = np.array([nnz, nnz // 2, 3, nnz], np.int32)
    for cap in (caps, np.int32(nnz)):
        plan = walk_plan(cols, n_out, nnz=cap, chunk=8)
        _check_plan(plan, cols, n_out, cap)
        _check_device_plan(plan, cols, n_out, cap)


def test_stack_plans_select_and_to_device():
    cols, n_out = _skewed_cols()
    plans = [walk_plan(cols, n_out, chunk=c) for c in (8,)] + \
        [walk_plan(cols[::-1].copy(), n_out, chunk=8)]
    stacked = stack_plans(plans)
    dev = to_device(stacked, "cpu")
    assert tuple(dev.counters.shape) == (2, 4, n_out)
    for i, p in enumerate(plans):
        one = dev.select(i)
        W = len(p.chunks)
        assert np.array_equal(one.chunks[:W].numpy(), p.chunks)
        assert bool((one.chunks[W:] == -1).all())
        assert np.array_equal(one.first.numpy(), p.first)
        assert one.counters.shape == (4, n_out)


def test_kernel_plan_builds_and_checks():
    cols, n_out = _skewed_cols()
    ct = torch.from_numpy(cols)
    plan, partials = kernel_plan(None, ct, n_out, None, 64, _raise)
    assert plan.chunk == default_chunk(64) == 8
    assert partials.shape == (plan.chunks.shape[0], 64)
    with pytest.raises(ValueError, match="first/count"):
        kernel_plan(plan, ct[:2], n_out, None, 64, _raise)
    with pytest.raises(ValueError, match="counters"):
        kernel_plan(walk_plan(cols, n_out, chunk=8), ct, n_out, None, 64,
                    _raise)


def _raise(cond, msg):
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


# ---------------------------------------------------------------------------
# the plain fold that follows a plan
# ---------------------------------------------------------------------------

def _fold_inputs(rng, sr, B, shared, P=3, n_out=4, nbb=5):
    """Skewed structure at a small size: partition 0 with one long run,
    partition 1 random, partition 2 empty; x per partition or shared."""
    T = 14
    nvb_in = nbb if shared else n_out
    cols = np.full((P, T), -1, np.int32)
    cols[0] = 2
    cols[1, :9] = np.sort(rng.integers(0, n_out, 9))
    rows = np.where(cols >= 0, rng.integers(0, nvb_in, (P, T)), -1
                    ).astype(np.int32)
    tiles = np.full((P, T, B, B), sr.zero, np.float32)
    live = (rng.random((P, T, B, B)) < 0.5) & (cols >= 0)[..., None, None]
    tiles[live] = rng.random(int(live.sum()))
    x = rng.random((1 if shared else P, nvb_in * B)).astype(np.float32)
    return tiles, rows, cols, x, n_out


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_part", "shared"])
def test_fold_by_plan_matches_reference(B, sr_name, shared):
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(B + 3 * shared + len(sr_name))
    tiles, rows, cols, x, n_out = _fold_inputs(rng, sr, B, shared)
    t = [torch.from_numpy(a) for a in (tiles, rows, cols, x)]
    ref = spmv_blocked_ref(*t, sr, n_out_blocks=n_out).numpy()
    for chunk in (1, 3, default_chunk(B)):
        plan = walk_plan(cols, n_out, chunk=chunk)
        got = fold_by_plan(t[0], t[1], t[3], plan, sr).numpy()
        _agree(got, ref, sr_name)
        dplan = walk_plan_torch(t[2], n_out, chunk=chunk)  # padded rows
        _agree(fold_by_plan(t[0], t[1], t[3], dplan, sr).numpy(), got,
               sr_name)
    P = tiles.shape[0]
    for p in range(P):  # the reference's Pallas SpMV, one partition
        want = j_spmv(jnp.asarray(tiles[p]), jnp.asarray(rows[p]),
                      jnp.asarray(cols[p]), jnp.asarray(x[0 if shared else p]),
                      jsr, n_out_blocks=n_out, use_pallas=True,
                      interpret=True)
        _agree(got[p], want, sr_name)
    # the reference's fused Pallas stage, combining with the semiring zero
    zero = np.full((P, n_out, B), sr.zero, np.float32)
    xo, _ = j_fused(jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
                    jnp.asarray(x.reshape(x.shape[0], -1, B)),
                    jnp.asarray(zero), jnp.asarray(zero),
                    jnp.ones(zero.shape, jnp.float32), jsr, use_pallas=True,
                    interpret=True)
    _agree(got, np.asarray(xo).reshape(P, -1), sr_name)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("which", ["long_run", "single_chunk_run"])
def test_dropped_chunk_fails_the_comparison(sr_name, which):
    """Control: the comparison above sees a plan that loses one chunk.
    The lost chunk's tiles carry negative weights, so that under min-plus
    they hold the minima (a min may not need every tile)."""
    sr, _ = SR[sr_name]
    rng = np.random.default_rng(7)
    tiles, rows, cols, x, n_out = _fold_inputs(rng, sr, 8, False)
    plan = walk_plan(cols, n_out, chunk=3)
    counts = plan.count.reshape(-1)
    sizes = plan.chunks[:, 3] - plan.chunks[:, 2]
    run_n = counts[plan.chunks[:, 0] * n_out + plan.chunks[:, 1]]
    pick = (run_n > 1) if which == "long_run" else (run_n == 1)
    drop = int(np.nonzero(pick & (sizes > 0))[0][0])
    p, _, t0, t1 = plan.chunks[drop]
    tiles[p, t0:t1] = -1.0 - rng.random((t1 - t0,) + tiles.shape[2:])
    t = [torch.from_numpy(a) for a in (tiles, rows, cols, x)]
    ref = spmv_blocked_ref(*t, sr, n_out_blocks=n_out).numpy()
    _agree(fold_by_plan(t[0], t[1], t[3], plan, sr).numpy(), ref, sr_name)
    cut = WalkPlan(run_ptr=plan.run_ptr, first=plan.first, count=plan.count,
                   chunks=np.delete(plan.chunks, drop, axis=0),
                   chunk=plan.chunk)
    with pytest.raises(AssertionError):
        _agree(fold_by_plan(t[0], t[1], t[3], cut, sr).numpy(), ref, sr_name)
