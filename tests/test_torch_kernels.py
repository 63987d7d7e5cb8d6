"""The port's kernels against the JAX package's kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
these are held against the reference's Pallas kernels in interpret mode
and its jnp oracles on the shapes ``tests/test_kernels.py`` sweeps.
Min-plus must agree bitwise (same inf pattern); plus-mul within 2e-5
(``tests/test_kernels.py:46``); halt votes exactly.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.core.semiring import PLUS_MUL as J_PLUS_MUL
from repro.kernels.semiring_spmm.ops import spmv_blocked as j_spmv
from repro.kernels.semiring_superstep.ops import fused_step as j_fused
from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
from repro_torch.kernels.semiring_spmm.ops import spmv_blocked
from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
from repro_torch.kernels.semiring_superstep.ops import fused_step

SR = {"min_plus": (MIN_PLUS, J_MIN_PLUS), "plus_mul": (PLUS_MUL, J_PLUS_MUL)}
TOL = 2e-5


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


def _structure(rng, B, nvb, T_valid, T_pad, zero, density, nvb_in=None):
    cols = np.sort(rng.integers(0, nvb, T_valid)).astype(np.int32)
    rows = rng.integers(0, nvb_in or nvb, T_valid).astype(np.int32)
    rows = np.concatenate([rows, np.full(T_pad, -1, np.int32)])
    cols = np.concatenate([cols, np.full(T_pad, -1, np.int32)])
    tiles = np.full((len(rows), B, B), zero, np.float32)
    for t in range(T_valid):
        m = rng.random((B, B)) < density
        tiles[t][m] = rng.random(int(m.sum()))
    return tiles, rows, cols


def _both_spmv(tiles, rows, cols, x, sr_name, **kw):
    """Port (CPU wrapper, plain version) and reference (Pallas interpret,
    jnp oracle) on the same inputs."""
    sr, jsr = SR[sr_name]
    nnz = kw.pop("nnz", None)
    got = spmv_blocked_cuda(torch.from_numpy(tiles), torch.from_numpy(rows),
                            torch.from_numpy(cols), torch.from_numpy(x), sr,
                            nnz=None if nnz is None else torch.tensor(nnz),
                            **kw)
    jargs = (jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
             jnp.asarray(x), jsr)
    pallas = j_spmv(*jargs, use_pallas=True, interpret=True,
                    nnz=None if nnz is None else jnp.asarray(nnz, jnp.int32),
                    **kw)
    oracle = j_spmv(*jargs, use_pallas=False, **kw)
    return got.numpy(), np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("B", [8, 16, 128])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_spmv_matches_reference(B, sr_name, density):
    rng = np.random.default_rng(B * 7 + int(density * 100))
    nvb = int(rng.integers(2, 6))
    tiles, rows, cols = _structure(rng, B, nvb, int(rng.integers(1, 14)),
                                   int(rng.integers(0, 4)),
                                   SR[sr_name][0].zero, density)
    x = rng.random(nvb * B).astype(np.float32)
    got, pallas, oracle = _both_spmv(tiles, rows, cols, x, sr_name)
    _agree(got, oracle, sr_name)
    _agree(got, pallas, sr_name)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_spmv_empty_structure(sr_name):
    """All-padding tile list -> all-zero (semiring) output."""
    sr, _ = SR[sr_name]
    B, nvb = 8, 3
    rows = np.full(4, -1, np.int32)
    tiles = np.full((4, B, B), sr.zero, np.float32)
    x = np.ones(nvb * B, np.float32)
    got, pallas, oracle = _both_spmv(tiles, rows, rows, x, sr_name)
    assert np.all(got == sr.zero)
    _agree(got, pallas, sr_name)
    _agree(got, oracle, sr_name)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("nnz", [0, 3, 7])
def test_spmv_packed_walk_nnz(sr_name, nnz):
    """Packed list with the valid-tile count: == the reference's Pallas
    walk with ``nnz`` == its oracle."""
    sr, _ = SR[sr_name]
    rng = np.random.default_rng(100 + nnz)
    B, nvb, T = 8, 4, 7
    tiles, rows, cols = _structure(rng, B, nvb, nnz, T - nnz, sr.zero, 1.0)
    x = rng.random(nvb * B).astype(np.float32)
    got, pallas, oracle = _both_spmv(tiles, rows, cols, x, sr_name,
                                     nnz=np.int32(nnz))
    _agree(got, pallas, sr_name)
    _agree(got, oracle, sr_name)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_spmv_packed_subset_matches_dense_walk(sr_name):
    """Dropping all-zero tiles from the walked list does not change the
    output (the sparse layout's claim at kernel level), bitwise."""
    sr, _ = SR[sr_name]
    rng = np.random.default_rng(5)
    B, nvb, T = 8, 4, 10
    cols = np.sort(rng.integers(0, nvb, T)).astype(np.int32)
    rows = rng.integers(0, nvb, T).astype(np.int32)
    tiles = np.full((T, B, B), sr.zero, np.float32)
    live = rng.random(T) < 0.5
    for t in np.nonzero(live)[0]:
        tiles[t] = rng.random((B, B))
    x = rng.random(nvb * B).astype(np.float32)
    k = int(live.sum())
    packed = np.full((T, B, B), sr.zero, np.float32)
    prows = np.full(T, -1, np.int32)
    pcols = np.full(T, -1, np.int32)
    packed[:k], prows[:k], pcols[:k] = tiles[live], rows[live], cols[live]
    dense, _, oracle = _both_spmv(tiles, rows, cols, x, sr_name,
                                  n_out_blocks=nvb)
    sparse, _, _ = _both_spmv(packed, prows, pcols, x, sr_name,
                              n_out_blocks=nvb, nnz=np.int32(k))
    assert np.array_equal(dense, sparse)
    _agree(dense, oracle, sr_name)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_part", "shared"])
def test_spmv_all_partitions_in_one_call(sr_name, shared):
    """The (P, T, B, B) form with per-partition or shared (consume) state
    == the reference vmapped over partitions, as its superstep calls it."""
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(17 + shared)
    B, P, nvb, nbb, T = 16, 3, 4, 6, 9
    parts = [_structure(rng, B, nvb, int(rng.integers(0, T + 1)), 0, sr.zero,
                        0.3, nvb_in=nbb if shared else nvb) for _ in range(P)]
    # pad every partition to T tiles
    tiles = np.full((P, T, B, B), sr.zero, np.float32)
    rows = np.full((P, T), -1, np.int32)
    cols = np.full((P, T), -1, np.int32)
    for p, (t_, r_, c_) in enumerate(parts):
        tiles[p, :len(r_)], rows[p, :len(r_)], cols[p, :len(r_)] = t_, r_, c_
    x = rng.random((1 if shared else P, (nbb if shared else nvb) * B)
                   ).astype(np.float32)
    got = spmv_blocked(torch.from_numpy(tiles), torch.from_numpy(rows),
                       torch.from_numpy(cols), torch.from_numpy(x), sr,
                       n_out_blocks=nvb).numpy()
    for p in range(P):
        want = j_spmv(jnp.asarray(tiles[p]), jnp.asarray(rows[p]),
                      jnp.asarray(cols[p]),
                      jnp.asarray(x[0 if shared else p]), jsr,
                      n_out_blocks=nvb, use_pallas=True, interpret=True)
        _agree(got[p], want, sr_name)


def _fused_inputs(rng, sr, shape, B, P=3, nvb=4, nbb=5, T=6):
    zero = sr.zero
    shared = shape == "consume"
    nvb_in = nbb if shared else nvb
    tiles = np.full((P, T, B, B), zero, np.float32)
    rows = np.full((P, T), -1, np.int32)
    cols = np.full((P, T), -1, np.int32)
    for p in range(P):
        n = int(rng.integers(0, T + 1)) if p else T
        t_, r_, c_ = _structure(rng, B, nvb, n, 0, zero, 0.4, nvb_in=nvb_in)
        tiles[p, :n], rows[p, :n], cols[p, :n] = t_, r_, c_
    x = rng.random((P, nvb, B)).astype(np.float32)
    if shape == "consume":
        x_in = rng.random((1, nbb, B)).astype(np.float32)
        x_comb, x_ref = x, rng.random((P, nvb, B)).astype(np.float32)
    elif shape == "sweep":
        x_in = x_comb = x_ref = x
    else:  # spmv: combine with the semiring zero
        x_in, x_ref = x, x
        x_comb = np.full_like(x, zero)
    vmask = rng.random((P, nvb, B)) < 0.9
    return tiles, rows, cols, x_in, x_comb, x_ref, vmask


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shape", ["sweep", "consume", "spmv"])
def test_fused_matches_reference(B, sr_name, shape):
    """Fused stage, all three call shapes: port == reference Pallas kernel
    (interpret) == reference oracle; halt votes exactly equal."""
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(B + len(shape) + len(sr_name))
    args = _fused_inputs(rng, sr, shape, B)
    got, gch = fused_step_cuda(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in args), sr)
    jargs = [jnp.asarray(a) for a in args]
    for use_pallas in (True, False):
        kw = dict(interpret=True) if use_pallas else {}
        want, wch = j_fused(*jargs, jsr, use_pallas=use_pallas, **kw)
        _agree(got.numpy(), np.asarray(want), sr_name)
        assert np.array_equal(gch.numpy(), np.asarray(wch))


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("shape", ["spmv", "consume"])
def test_fused_without_combine_or_vote(sr_name, shape):
    """``x_comb=None, x_ref=None`` (PageRank's step) == the reference's
    fused kernel combining with a zero state, its vote dropped, and ==
    the port's plain SpMV, bitwise."""
    sr, jsr = SR[sr_name]
    rng = np.random.default_rng(40 + len(shape) + len(sr_name))
    tiles, rows, cols, x_in, _, x_ref, vmask = _fused_inputs(rng, sr, shape,
                                                             8)
    nvb = x_ref.shape[1]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (tiles, rows, cols, x_in)]
    got, changed = fused_step_cuda(*t, None, None, None, sr,
                                   n_out_blocks=nvb)
    assert changed is None
    zero = np.full(x_ref.shape, sr.zero, np.float32)
    want, _ = j_fused(*(jnp.asarray(a) for a in (tiles, rows, cols, x_in,
                                                  zero, x_ref, vmask)),
                      jsr, use_pallas=True, interpret=True)
    _agree(got.numpy(), np.asarray(want), sr_name)
    plain = spmv_blocked(*t[:3], t[3].reshape(t[3].shape[0], -1), sr,
                         n_out_blocks=nvb)
    assert torch.equal(got.reshape(plain.shape), plain)


@pytest.mark.parametrize("sr_name", ["min_plus", "plus_mul"])
def test_fused_untouched_blocks_vote(sr_name):
    """Blocks no tile touches keep x_comb and still vote: in the consume
    shape x_comb != x_ref there, so the partition reports a change."""
    sr, _ = SR[sr_name]
    B, P, nvb = 8, 2, 3
    tiles = torch.full((P, 2, B, B), sr.zero)
    rows = torch.full((P, 2), -1, dtype=torch.int32)
    x_comb = torch.rand(P, nvb, B)
    x_ref = x_comb.clone()
    x_ref[1, 2, 3] += 1.0  # only partition 1 differs, in an empty block
    vmask = torch.ones(P, nvb, B, dtype=torch.bool)
    out, changed = fused_step(tiles, rows, rows, torch.rand(1, 2, B),
                              x_comb, x_ref, vmask, sr)
    assert torch.equal(out, x_comb)
    assert changed.flatten().tolist() == [0, 1]


def test_float_mask_accepted_by_dispatch():
    """``fused_step`` takes a 0/1 float mask as the reference does."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            _fused_inputs(rng, MIN_PLUS, "sweep", 8)]
    a = fused_step(*args, MIN_PLUS)
    args[-1] = args[-1].float()
    b = fused_step(*args, MIN_PLUS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_wrappers_count_no_launches():
    """The CPU path runs the plain version and launches nothing."""
    before = (spmv_blocked_cuda.launches, fused_step_cuda.launches)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            _fused_inputs(np.random.default_rng(4), PLUS_MUL, "sweep", 8)]
    fused_step_cuda(*args, PLUS_MUL)
    spmv_blocked_cuda(*args[:3], args[3].reshape(3, -1), PLUS_MUL)
    assert (spmv_blocked_cuda.launches, fused_step_cuda.launches) == before
