"""The wgmma flash backward's block schedule and its plain tiled version,
held on the CPU.

``bwd_schedule`` (``repro_torch/kernels/flash_attention/schedule.py``)
has the formulas the two kernels of the backward's ``bf16_wgmma`` route
use: the query blocks a dK/dV CTA visits for its keys, the key blocks a
dQ CTA visits for its rows, the sub-ranges that need no mask, and the
launch order.  A brute force over the mask checks them: every visible
(query, key) pair lies in a visited block, every visited block holds a
visible pair, and no mask-free block holds a masked pair, a row past Sq
or a key past Skv.  ``tiled_bwd_ref``, which follows the schedule with
the kernels' rounding points and masks only the edge blocks, is held
against ``jax.vjp`` of the reference's ``chunked_attention`` and the
plain backward ``mha_bwd_ref``: float32 within 1e-5 (the tolerance of
``tests/test_torch_train.py``'s backward check), bfloat16 within
``grad_limit`` at 2e-2 (the card's limit).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention.bwd import (
    ROUTES, flash_attention_bwd_cuda)
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref
from repro_torch.kernels.flash_attention.schedule import (
    bwd_schedule, tiled_bwd_ref)

KERNEL_BLOCKS = (128, 64, 128, 64)  # (kvb, qs, qr, ks) of the kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _visible(Sq, Skv, causal, window, q_offset):
    """(Sq, Skv) mask of visible pairs, written out from the definition."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
    return ok


def _check(Sq, Skv, causal, window, q_offset, kvb, qs, qr, ks):
    sch = bwd_schedule(Sq, Skv, causal=causal, window=window,
                       q_offset=q_offset, kvb=kvb, qs=qs, qr=qr, ks=ks)
    vis = _visible(Sq, Skv, causal, window, q_offset)
    assert sch.dkdv.shape == (-(-Skv // kvb), 4)
    assert sch.dq.shape == (-(-Sq // qr), 4)
    for kb, (qb_lo, qb_hi, qf_lo, qf_hi) in enumerate(sch.dkdv):
        assert qb_lo <= qf_lo <= qf_hi <= qb_hi
        cols = vis[:, kb * kvb:(kb + 1) * kvb]
        assert {i // qs for i in np.nonzero(cols.any(1))[0]} == set(
            range(qb_lo, qb_hi))
        for qb in range(qf_lo, qf_hi):  # mask-free: whole and all visible
            assert (qb + 1) * qs <= Sq and (kb + 1) * kvb <= Skv
            assert cols[qb * qs:(qb + 1) * qs].all()
    for qb, (jb_lo, jb_hi, jf_lo, jf_hi) in enumerate(sch.dq):
        assert jb_lo <= jf_lo <= jf_hi <= jb_hi
        rows = vis[qb * qr:(qb + 1) * qr]
        assert {j // ks for j in np.nonzero(rows.any(0))[0]} == set(
            range(jb_lo, jb_hi))
        for j in range(jf_lo, jf_hi):
            assert (qb + 1) * qr <= Sq and (j + 1) * ks <= Skv
            assert rows[:, j * ks:(j + 1) * ks].all()
    assert sorted(sch.dkdv_order) == list(range(len(sch.dkdv)))
    assert sorted(sch.dq_order) == list(range(len(sch.dq)))
    return sch


@settings(max_examples=300, deadline=None)
@given(Sq=st.integers(1, 300), Skv=st.integers(1, 300),
       window=st.integers(0, 300), q_offset=st.integers(0, 300),
       causal=st.booleans(),
       blocks=st.sampled_from([KERNEL_BLOCKS, (32, 16, 32, 16),
                               (16, 32, 64, 16), (64, 64, 32, 32)]))
def test_bwd_schedule_matches_brute_force(Sq, Skv, window, q_offset, causal,
                                          blocks):
    _check(Sq, Skv, causal, window, q_offset, *blocks)


@pytest.mark.parametrize("case", [
    # (Sq, Skv, causal, window, q_offset): edges of the formulas
    (128, 128, True, 0, 0),  # one diagonal block
    (1, 33, True, 8, 32),  # one query row after a cache
    (100, 612, True, 256, 512),  # a continued step
    (77, 130, False, 0, 0),  # no mask but the ragged tails
    (300, 300, True, 64, 0),  # window = one query step
    (64, 300, True, 10, 400),  # windows past the last key: rows see none
    (256, 256, True, 1, 0),  # each row sees itself only
    (40, 1000, True, 700, 960),  # one ragged query block
    (257, 390, True, 0, 133),  # causal only, continued
])
def test_bwd_schedule_edge_cases(case):
    _check(*case, *KERNEL_BLOCKS)


def test_bwd_schedule_empty_ranges():
    """Keys that no row sees get an empty query range (their dK, dV are
    0), and rows that see no key an empty key range (their dQ is 0)."""
    sch = _check(64, 300, True, 10, 400, *KERNEL_BLOCKS)
    assert (sch.dkdv[:, 0] == sch.dkdv[:, 1]).all()
    assert (sch.dq[:, 0] == sch.dq[:, 1]).all()
    sch = _check(8, 1000, True, 4, 0, *KERNEL_BLOCKS)
    assert (sch.dkdv[1:, 0] == sch.dkdv[1:, 1]).all()


def test_bwd_schedule_at_the_training_shape():
    """starcoder2-7b's training layer (4,096 tokens, window 4,096: causal
    only).  Key block n of 128 sees 64 - 2n query blocks of 64 in each of
    the 9 heads of its group: 576 steps for n = 0, down to 18, 152,064
    over the 32 key blocks of the 16 (batch, KV head) pairs at B = 4.  Both
    grids launch their longest CTAs first: key blocks from the first, query
    blocks (128 rows, key blocks of 64) from the last."""
    sch = bwd_schedule(4096, 4096, causal=True, window=4096, q_offset=0)
    steps = 9 * (sch.dkdv[:, 1] - sch.dkdv[:, 0])
    assert steps[0] == 576 and steps[-1] == 18
    assert (np.diff(steps) == -18).all()
    assert 4 * 4 * steps.sum() == 152_064
    # the diagonal: the first two query blocks of each head take the mask
    assert ((sch.dkdv[:, 2] - sch.dkdv[:, 0]) == 2).all()
    assert (sch.dkdv[:, 3] == sch.dkdv[:, 1]).all()
    assert (np.diff(steps[sch.dkdv_order]) <= 0).all()
    blocks = sch.dq[:, 1] - sch.dq[:, 0]
    assert list(blocks) == [2 * (qb + 1) for qb in range(32)]
    assert (np.diff(blocks[sch.dq_order]) <= 0).all()
    assert ((blocks - (sch.dq[:, 3] - sch.dq[:, 2])) == 2).all()


def grad_limit(ref, tol):
    """``tests/test_torch_cuda.py``'s limit on |kernel - plain| for an
    attention gradient: ``tol * (|ref| + 2 * max(row mean, tensor
    mean))``."""
    a = ref.abs()
    row = torch.maximum(a.mean(dim=-1, keepdim=True), a.mean())
    return tol * (a + 2.0 * row)


def _inputs(B, Sq, Skv, H, K, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, K, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


# (B, Sq, Skv, H, K, d, causal, window, q_offset, blocks): every row sees
# a key (the reference averages all keys for a row that sees none)
VJP_CASES = [
    (2, 37, 37, 4, 2, 16, True, 9, 0, (32, 16, 32, 16)),  # G = 2, window
    (1, 50, 80, 6, 2, 32, True, 20, 30, (32, 16, 32, 16)),  # q_offset
    (1, 45, 45, 3, 3, 32, False, 0, 0, (32, 16, 32, 16)),  # not causal
    (1, 41, 41, 8, 1, 16, True, 0, 0, (16, 32, 64, 16)),  # G = 8
    (1, 300, 300, 4, 1, 16, True, 200, 0, KERNEL_BLOCKS),  # kernel blocks
]


@pytest.mark.parametrize("case", VJP_CASES,
                         ids=[f"case{i}" for i in range(len(VJP_CASES))])
def test_tiled_bwd_ref_matches_jax_vjp(case):
    B, Sq, Skv, H, K, d, causal, window, qoff, blocks = case
    q, k, v, do = _inputs(B, Sq, Skv, H, K, d, Sq + Skv)
    qpos = jnp.broadcast_to(jnp.arange(Sq)[None] + qoff, (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv))

    def f(q, k, v):
        return j_chunked(q, k, v, q_positions=qpos, kv_positions=kpos,
                         causal=causal, window=window or None, chunk=16)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o, lse = mha_ref(tq, tk, tv, return_lse=True, **kw)
    kvb, qs, qr, ks = blocks
    got = tiled_bwd_ref(tq, tk, tv, o, lse, tdo, kvb=kvb, qs=qs, qr=qr,
                        ks=ks, **kw)
    plain = mha_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for a, b, c in zip(got, want, plain):
        assert a.dtype == torch.float32 and a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", [
    (1, 300, 300, 9, 1, 64, True, 100, 0),  # G = 9, a window that bites
    (2, 77, 130, 4, 2, 128, True, 0, 53),  # ragged, continued
    (1, 129, 129, 4, 4, 64, False, 0, 0),  # no mask but the ragged tail
])
def test_tiled_bwd_ref_bf16_within_the_card_limit(case):
    """With the kernels' blocks and bf16 inputs (P and dS rounded to bf16),
    within the card's ``grad_limit`` of the plain backward in float32."""
    B, Sq, Skv, H, K, d, causal, window, qoff = case
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(B, Sq, Skv, H, K, d, Sq))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o, lse = mha_ref(q, k, v, return_lse=True, **kw)
    got = tiled_bwd_ref(q, k, v, o, lse, do, **kw)
    want = mha_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                       **kw)
    for a, c in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert bool(((a.float() - c).abs() <= grad_limit(c, 2e-2)).all())


def test_wrapper_on_cpu_runs_the_plain_version():
    """``ROUTES`` names the three routes; on CPU tensors the wrapper is the
    plain backward and counts no launch."""
    assert ROUTES == ("f32", "bf16_mma_sync", "bf16_wgmma")
    q, k, v, do = (torch.tensor(a) for a in _inputs(1, 40, 40, 4, 2, 64, 3))
    o, lse = mha_ref(q, k, v, window=16, return_lse=True)
    before = (flash_attention_bwd_cuda.launches,
              dict(flash_attention_bwd_cuda.launches_by_route))
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, window=16)
    want = mha_bwd_ref(q, k, v, o, lse, do, window=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_attention_bwd_cuda.launches,
            flash_attention_bwd_cuda.launches_by_route) == before
    assert set(before[1]) == set(ROUTES)
