"""The wgmma flash kernel's block schedule, held on the CPU.

``block_schedule`` (``repro_torch/kernels/flash_attention/schedule.py``)
has the formulas the kernel uses to pick each query block's key blocks
and the sub-range that needs no mask.  A brute force over the mask checks
them: every visible (query, key) pair lies in a visited block, every
visited block holds a visible pair, and no mask-free block holds a masked
pair.  ``tiled_ref``, which follows the schedule with an online softmax
and masks only the edge blocks, is held against the reference's Pallas
kernel in interpret mode and its jnp oracle, with the tolerances of
``tests/test_torch_attention.py`` (2e-5 float32, 2e-2 bfloat16).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention.kernel import (
    ROUTES, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.flash_attention.schedule import (
    block_schedule, tiled_ref)


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


def _check_schedule(Sq, Skv, causal, window, q_offset, bm, bn):
    sched = block_schedule(Sq, Skv, causal=causal, window=window,
                           q_offset=q_offset, bm=bm, bn=bn)
    vis = _visible(Sq, Skv, causal, window, q_offset)
    assert sched.shape == (-(-Sq // bm), 4)
    for qb, (jb_lo, jb_hi, jf_lo, jf_hi) in enumerate(sched):
        assert jb_lo <= jf_lo <= jf_hi <= jb_hi
        rows = vis[qb * bm:(qb + 1) * bm]
        blocks = {j // bn for j in np.nonzero(rows.any(0))[0]}
        # every visible pair in a visited block, every visited block holds
        # one (so a block wholly outside the mask is never visited)
        assert blocks == set(range(jb_lo, jb_hi))
        for j in range(jf_lo, jf_hi):  # mask-free: all pairs visible
            assert (j + 1) * bn <= Skv
            assert rows[:, j * bn:(j + 1) * bn].all()


@settings(max_examples=400, deadline=None)
@given(Sq=st.integers(1, 300), Skv=st.integers(1, 300),
       window=st.integers(0, 300), q_offset=st.integers(0, 300),
       causal=st.booleans(),
       blocks=st.sampled_from([(128, 128), (32, 32), (64, 32), (32, 64),
                               (16, 128)]))
def test_block_schedule_matches_brute_force(Sq, Skv, window, q_offset,
                                            causal, blocks):
    _check_schedule(Sq, Skv, causal, window, q_offset, *blocks)


@pytest.mark.parametrize("case", [
    # (Sq, Skv, causal, window, q_offset, bm, bn): edges of the formulas
    (128, 128, True, 0, 0, 128, 128),  # one diagonal block
    (1, 33, True, 8, 32, 128, 128),  # one query row after a cache
    (100, 612, True, 256, 512, 128, 128),  # a continued prefill
    (77, 130, False, 0, 0, 128, 128),  # no mask but the ragged tail
    (300, 300, True, 128, 0, 128, 128),  # window = one block
    (64, 300, True, 10, 400, 32, 32),  # windows past the last key
    (256, 256, True, 1, 0, 128, 128),  # each row sees itself only
])
def test_block_schedule_edge_cases(case):
    _check_schedule(*case)


def test_block_schedule_at_the_serving_shape():
    """starcoder2-7b's prefill (8,192 tokens, window 4,096): at most 33
    key blocks per query block, of which at most two take the mask; 24.75
    blocks on average, the count behind the kernel's K/V traffic."""
    sched = block_schedule(8192, 8192, causal=True, window=4096,
                           q_offset=0)
    visited = sched[:, 1] - sched[:, 0]
    edges = visited - (sched[:, 3] - sched[:, 2])
    assert visited.max() == 33 and edges.max() == 2
    assert visited.mean() == 24.75
    assert (sched[32:, 1] - sched[32:, 0] == 33).all()


def _tol(dt):
    return 2e-2 if dt == "bfloat16" else 2e-5


def _both(a, dt):
    """One numpy array as a jax array and a torch tensor of type ``dt``."""
    j = jnp.asarray(a, getattr(jnp, dt))
    t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dt))
    return j, t


def _case(case, seed):
    B, Sq, Skv, H, K, d, causal, window, qoff, dt = case
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=s), dt)
        for s in ((B, Sq, H, d), (B, Skv, K, d), (B, Skv, K, d)))
    return (jq, jk, jv), (q, k, v), dict(causal=causal, window=window,
                                         q_offset=qoff)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (B, Sq, Skv, H, K, d, causal, window, q_offset, dtype); Sq and Skv
# multiples of 32 so that the Pallas kernel takes them at bq = bk = 32
PALLAS_CASES = [
    (1, 64, 64, 3, 1, 32, True, 0, 0, "float32"),  # G = 3
    (2, 96, 96, 6, 2, 32, True, 40, 0, "float32"),  # window over blocks
    (1, 64, 128, 3, 3, 32, True, 0, 64, "bfloat16"),  # q_offset > 0
    (1, 64, 64, 2, 2, 32, False, 0, 0, "float32"),  # not causal
    (1, 96, 96, 3, 1, 32, True, 24, 0, "bfloat16"),  # window < a block
]
# ragged tails (the Pallas kernel needs whole blocks): the jnp oracle only
RAGGED_CASES = [
    (1, 50, 70, 3, 1, 32, True, 20, 20, "float32"),
    (2, 37, 81, 6, 2, 32, True, 40, 44, "bfloat16"),
    (1, 45, 45, 3, 3, 32, False, 0, 0, "float32"),
]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_tiled_ref_matches_pallas(case):
    (jq, jk, jv), (q, k, v), kw = _case(case, 7)
    got = tiled_ref(q, k, v, bm=32, bn=32, **kw)
    tol = _tol(case[-1])
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, j_flash(jq, jk, jv, use_pallas=True, interpret=True, bq=32,
                        bk=32, **kw), tol)
    _close(got, j_flash(jq, jk, jv, use_pallas=False, **kw), tol)
    _close(got, mha_ref(q, k, v, **kw).float().numpy(), tol)


@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=[f"ragged{i}" for i in range(len(RAGGED_CASES))])
def test_tiled_ref_ragged_matches_jax(case):
    (jq, jk, jv), (q, k, v), kw = _case(case, 8)
    tol = _tol(case[-1])
    got = tiled_ref(q, k, v, bm=32, bn=32, **kw)
    _close(got, j_flash(jq, jk, jv, use_pallas=False, **kw), tol)
    _close(got, mha_ref(q, k, v, **kw).float().numpy(), tol)


def test_tiled_ref_at_the_kernel_blocks():
    """At the kernel's own 128 x 128 blocks, over several query blocks with
    edge blocks on both sides of the window and a ragged tail."""
    (_, _, _), (q, k, v), kw = _case(
        (1, 300, 300, 2, 1, 16, True, 200, 0, "float32"), 9)
    _close(tiled_ref(q, k, v, **kw), mha_ref(q, k, v, **kw).numpy(), 2e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    (_, _, _), (q, k, v), kw = _case(
        (1, 40, 40, 4, 2, 64, True, 16, 0, "bfloat16"), 10)
    before = dict(flash_attention_cuda.launches_by_route)
    assert torch.equal(flash_attention_cuda(q, k, v, **kw),
                       mha_ref(q, k, v, **kw))
    assert flash_attention_cuda.launches_by_route == before
    assert set(before) == set(ROUTES)


def test_flash_variants_apply_to_the_source(tmp_path, monkeypatch):
    """tools/flash_variants.py times design variants of the kernel made by
    textual edits of the committed source: each edit must still apply."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "flash_variants.py"
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    fv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fv)
    monkeypatch.setattr(fv, "OUT", tmp_path)
    for name, edits in fv.VARIANTS.items():
        text = (fv.make_tree(name) / fv.CU).read_text()
        for _, new in edits:
            assert new in text
