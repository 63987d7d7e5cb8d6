"""The decode kernel's split schedule, held on the CPU.

``num_splits`` and ``split_ranges``
(``repro_torch/kernels/decode_attention/schedule.py``) have the formulas
the ring kernel uses to cut each sequence's valid cache range into splits
of whole 64-key blocks.  A brute force over the reference's mask checks
them: every valid slot lies in exactly one split, no split holds a slot
outside the mask, and the B·K·nsplit CTAs fit one wave.  ``tiled_ref``,
which follows the schedule and the kernel's warp-by-warp online softmax,
is held against ``decode_ref``, the reference's jnp oracle and its Pallas
kernel in interpret mode, with the reference's tolerances (2e-5 float32,
2e-2 bfloat16, ``tests/test_kernels.py:197``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro_torch.kernels.decode_attention.kernel import (
    ROUTES, decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.decode_attention.schedule import (
    KB, num_splits, split_ranges, tiled_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _valid(length, S, window):
    """The reference's mask for one sequence, written out."""
    j = np.arange(S)
    ok = j < length
    if window:
        ok &= j > length - 1 - window
    return ok


def _check(lengths, S, window, bk, sms):
    span = min(S, window) if window else S
    n = num_splits(bk, span, sms)
    assert 1 <= n <= max(1, -(-span // KB))
    assert n == 1 or bk * n <= sms  # one wave
    ranges = split_ranges(lengths, S, window, n)
    assert ranges.shape == (len(lengths), n, 2)
    for length, rows in zip(lengths, ranges):
        seen = np.zeros(S, int)
        sizes = rows[:, 1] - rows[:, 0]
        assert (sizes >= 0).all()
        for c0, c1 in rows:
            seen[c0:c1] += 1
        assert (seen == _valid(length, S, window)).all()
        busy = np.nonzero(sizes)[0]
        if len(busy):
            # the busy splits come first, each of nb whole blocks but the
            # last, which holds the ragged tail
            assert (busy == np.arange(len(busy))).all()
            nb = -(-sizes[0] // KB)
            assert (sizes[busy[:-1]] == nb * KB).all()
            assert 0 < sizes[busy[-1]] <= nb * KB
            assert nb == -(-(-(-int(sizes.sum()) // KB)) // n)
    return n, ranges


@settings(max_examples=400, deadline=None)
@given(S=st.integers(1, 700), window=st.integers(0, 800),
       bk=st.integers(1, 600), sms=st.sampled_from([132, 114, 16, 1]),
       lengths=st.lists(st.integers(-70, 900), min_size=1, max_size=4))
def test_split_ranges_match_brute_force(S, window, bk, sms, lengths):
    _check(lengths, S, window, bk, sms)


@pytest.mark.parametrize("lengths,S,window", [
    ([0, -3], 100, 0),  # nothing valid
    ([1], 100, 0),  # one slot
    ([1], 100, 16),
    ([65, 64, 63], 200, 0),  # around one block
    ([300], 200, 0),  # clamped to the cache
    ([300], 200, 64),  # the window's start past the clamp
    ([400], 200, 64),  # the window wholly past the cache: nothing valid
    ([129], 200, 129),  # window = length
])
def test_split_ranges_edge_cases(lengths, S, window):
    for bk, sms in ((1, 132), (3, 132), (200, 132)):
        _check(lengths, S, window, bk, sms)


def test_split_schedule_at_the_serving_and_32k_shapes():
    """starcoder2-7b's serving decode (4 sequences x 4 KV heads at about
    8.2k tokens, window 4,096): 8 splits of 8 blocks, 128 CTAs on 132 SMs.
    decode_32k's cache (128 x 4): one split of up to 64 blocks."""
    n, ranges = _check([8193] * 4, 8232, 4096, 16, 132)
    assert n == 8
    assert ((ranges[..., 1] - ranges[..., 0]) == 8 * KB).all()
    n, ranges = _check([32768, 5, 4096, 4097], 32768, 4096, 512, 132)
    assert n == 1
    assert (ranges[:, 0, 1] - ranges[:, 0, 0]).tolist() == [4096, 5, 4096,
                                                             4096]


def _both(a, dt):
    """One numpy array as a jax array and a torch tensor of type ``dt``."""
    j = jnp.asarray(a, getattr(jnp, dt))
    t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dt))
    return j, t


def _case(B, S, H, K, d, dt, lengths, seed):
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=s), dt)
        for s in ((B, H, d), (B, S, K, d), (B, S, K, d)))
    lens = np.asarray(lengths, np.int32)
    return (jq, jk, jv, jnp.asarray(lens)), (q, k, v, torch.as_tensor(lens))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (B, S, H, K, d, window, dtype, lengths): S a multiple of 64 so that the
# Pallas kernel takes it at bk = 64; G = 9 and 16, d = 64 and 128; lengths
# of 1, not a multiple of 64 or 16, the whole cache, and past it
TILED_CASES = [
    (2, 128, 9, 1, 64, 0, "float32", [1, 100]),
    (2, 192, 18, 2, 128, 48, "bfloat16", [192, 77]),
    (1, 256, 16, 1, 128, 100, "float32", [233]),
    (3, 128, 32, 2, 64, 0, "bfloat16", [128, 1, 65]),
    (2, 128, 36, 4, 128, 64, "bfloat16", [150, 90]),
    (1, 192, 16, 1, 64, 0, "float32", [300]),
]


@pytest.mark.parametrize("nsplit", [None, 1, 3])
@pytest.mark.parametrize("case", TILED_CASES,
                         ids=[f"case{i}" for i in range(len(TILED_CASES))])
def test_tiled_ref_matches_reference(case, nsplit):
    B, S, H, K, d, window, dt, lengths = case
    (jq, jk, jv, jl), (q, k, v, lens) = _case(B, S, H, K, d, dt, lengths,
                                               len(lengths) + S)
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    got = tiled_ref(q, k, v, lens, window=window, nsplit=nsplit)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, decode_ref(q, k, v, lens, window=window).float().numpy(),
           tol)
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=False),
           tol)
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=True,
                         interpret=True, bk=64), tol)


def test_tiled_ref_empty_ranges_give_zero_as_the_pallas_kernel():
    """A sequence with no valid slot (length <= 0, or a window wholly past
    the cache) gets 0 from the TPU kernel and from the schedule; the
    others are unaffected.  (The jnp oracle and ``decode_ref`` give such a
    row the mean of V instead: a softmax over nothing but masked logits.)"""
    B, S, H, K, d, window = 4, 128, 9, 1, 64, 32
    lengths = [0, -5, 200, 70]
    (jq, jk, jv, jl), (q, k, v, lens) = _case(B, S, H, K, d, "float32",
                                               lengths, 5)
    got = tiled_ref(q, k, v, lens, window=window)
    assert (got[:3] == 0).all()
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=True,
                         interpret=True, bk=64), 2e-5)
    _close(got[3:], decode_ref(q[3:], k[3:], v[3:], lens[3:],
                               window=window).numpy(), 2e-5)


@pytest.mark.parametrize("nsplit", [1, 2, 7, 40])
def test_tiled_ref_split_counts_agree(nsplit):
    """Any split count, empty splits included, gives the plain version's
    result: the splits' combine in split order is exact up to rounding."""
    (_, _, _, _), (q, k, v, lens) = _case(2, 300, 9, 1, 128, "float32",
                                          [300, 131], 6)
    _close(tiled_ref(q, k, v, lens, window=250, nsplit=nsplit),
           decode_ref(q, k, v, lens, window=250).numpy(), 2e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    (_, _, _, _), (q, k, v, lens) = _case(2, 70, 18, 2, 64, "bfloat16",
                                          [70, 9], 7)
    before = (decode_attention_cuda.launches,
              dict(decode_attention_cuda.launches_by_route))
    assert torch.equal(decode_attention_cuda(q, k, v, lens, window=30),
                       decode_ref(q, k, v, lens, window=30))
    assert (decode_attention_cuda.launches,
            decode_attention_cuda.launches_by_route) == before
    assert set(before[1]) == set(ROUTES)


def test_decode_variants_apply_to_the_source(tmp_path, monkeypatch):
    """tools/decode_variants.py times design variants of the kernel made
    by textual edits of the committed sources: each edit must still
    apply."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "decode_variants.py"
    spec = importlib.util.spec_from_file_location("decode_variants", path)
    dv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dv)
    monkeypatch.setattr(dv, "OUT", tmp_path)
    for name, edits in dv.VARIANTS.items():
        src = dv.make_tree(name)
        for rel, _, new in edits:
            assert new in (src / rel).read_text()
