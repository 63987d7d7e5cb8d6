"""The port's attention against the JAX package's.

On the CPU the port's flash and decode wrappers run their plain PyTorch
versions; these are held against the reference's Pallas kernels in
interpret mode (``bq = bk = 32`` and ``bk = 64``, as ``tests/test_kernels.py``
runs them) and its jnp oracles, on the sweeps of ``tests/test_kernels.py``
plus ragged tails, G = 9, windows longer than the sequence and length-1
caches.  Tolerances are the reference's own: 2e-5 for float32, 2e-2 for
bfloat16 (``tests/test_kernels.py:150``, ``:197``).  The CUDA kernels are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, num_splits)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models.attention import chunked_attention

# (B, Sq, Skv, H, K, d, causal, window, q_offset, dtype): tests/test_kernels.py
FLASH_SWEEP = [
    (2, 64, 64, 4, 2, 32, True, 0, 0, "float32"),
    (1, 128, 128, 8, 8, 64, True, 0, 0, "float32"),
    (2, 32, 32, 4, 1, 16, False, 0, 0, "float32"),
    (1, 64, 64, 2, 2, 32, True, 24, 0, "float32"),
    (1, 32, 96, 4, 2, 32, True, 0, 64, "float32"),
    (1, 64, 64, 4, 2, 32, True, 0, 0, "bfloat16"),
    (1, 128, 128, 2, 2, 128, True, 0, 0, "float32"),
]
# shapes the Pallas kernel does not take (ragged tails), held against the
# reference's jnp oracle only
FLASH_EXTRA = [
    (1, 50, 50, 9, 1, 32, True, 16, 0, "float32"),  # G = 9, ragged
    (2, 37, 81, 4, 2, 64, True, 200, 44, "float32"),  # window > length
    (1, 70, 70, 18, 2, 128, True, 64, 0, "bfloat16"),  # the serve shape
    (1, 1, 33, 4, 1, 16, True, 8, 32, "bfloat16"),  # one query
]
# (B, S, H, K, d, window, dtype): tests/test_kernels.py
DECODE_SWEEP = [
    (2, 128, 4, 2, 32, 0, "float32"),
    (1, 256, 8, 1, 64, 0, "float32"),
    (3, 128, 4, 4, 32, 48, "float32"),
    (2, 128, 8, 2, 64, 0, "bfloat16"),
]
DECODE_EXTRA = [
    (3, 100, 9, 1, 128, 0, "float32"),  # G = 9, ragged cache
    (2, 77, 18, 2, 64, 500, "bfloat16"),  # window > cache
    (4, 64, 36, 4, 128, 16, "bfloat16"),  # starcoder2's G and d
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dt):
    return 2e-2 if dt == "bfloat16" else 2e-5


def _both(a, dt):
    """One numpy array as a jax array and a torch tensor of type ``dt``."""
    j = jnp.asarray(a, getattr(jnp, dt))
    t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dt))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _flash_case(case, seed):
    B, Sq, Skv, H, K, d, causal, window, qoff, dt = case
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=s), dt)
        for s in ((B, Sq, H, d), (B, Skv, K, d), (B, Skv, K, d)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    return (jq, jk, jv), (q, k, v), kw


@pytest.mark.parametrize("case", FLASH_SWEEP,
                         ids=[f"case{i}" for i in range(len(FLASH_SWEEP))])
def test_flash_plain_matches_jax(case):
    (jq, jk, jv), (q, k, v), kw = _flash_case(case, 1)
    got = flash_attention_cuda(q, k, v, **kw)  # CPU: the plain version
    tol = _tol(case[-1])
    _close(got, j_flash(jq, jk, jv, use_pallas=False, **kw), tol)
    _close(got, j_flash(jq, jk, jv, use_pallas=True, interpret=True, bq=32,
                        bk=32, **kw), tol)
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize("case", FLASH_EXTRA,
                         ids=[f"extra{i}" for i in range(len(FLASH_EXTRA))])
def test_flash_plain_ragged_matches_jax(case):
    (jq, jk, jv), (q, k, v), kw = _flash_case(case, 2)
    got = flash_attention_cuda(q, k, v, **kw)
    _close(got, j_flash(jq, jk, jv, use_pallas=False, **kw), _tol(case[-1]))
    # query chunks (which narrow the keys each chunk reads) change nothing
    # beyond rounding
    from repro_torch.kernels.flash_attention.ref import mha_ref
    _close(mha_ref(q, k, v, chunk=7, **kw), got.float().numpy(),
           _tol(case[-1]))


def _decode_case(case, seed):
    B, S, H, K, d, window, dt = case
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=s), dt)
        for s in ((B, H, d), (B, S, K, d), (B, S, K, d)))
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    lens[0] = 1  # a cache of one token
    return (jq, jk, jv, jnp.asarray(lens)), \
        (q, k, v, torch.as_tensor(lens)), window


@pytest.mark.parametrize("case", DECODE_SWEEP,
                         ids=[f"case{i}" for i in range(len(DECODE_SWEEP))])
def test_decode_plain_matches_jax(case):
    (jq, jk, jv, jl), (q, k, v, lens), window = _decode_case(case, 3)
    got = decode_attention_cuda(q, k, v, lens, window=window)
    tol = _tol(case[-1])
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=False),
           tol)
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=True,
                         interpret=True, bk=64), tol)
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize("case", DECODE_EXTRA,
                         ids=[f"extra{i}" for i in range(len(DECODE_EXTRA))])
def test_decode_plain_ragged_matches_jax(case):
    (jq, jk, jv, jl), (q, k, v, lens), window = _decode_case(case, 4)
    got = decode_attention_cuda(q, k, v, lens, window=window)
    _close(got, j_decode(jq, jk, jv, jl, window=window, use_pallas=False),
           _tol(case[-1]))


@pytest.mark.parametrize("window", [None, 24, 200])
@pytest.mark.parametrize("extra", ["kv_len", None])
@pytest.mark.parametrize("chunk", [16, 1024])
def test_chunked_attention_matches_jax(window, extra, chunk):
    """The port's plain oracle of the model path against the reference's,
    on a cache with unwritten slots (pos = -2^30), chunks that do not
    divide the cache or exceed it, windows and ``kv_len``."""
    rng = np.random.default_rng(5)
    B, Sq, S, H, K, d = 2, 9, 70, 6, 2, 32
    q = rng.normal(size=(B, Sq, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, K, d)).astype(np.float32)
    v = rng.normal(size=(B, S, K, d)).astype(np.float32)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_pos[1, 60:] = -(2 ** 30)  # unwritten
    q_pos = np.stack([np.arange(50, 50 + Sq), np.arange(40, 40 + Sq)])
    q_pos = q_pos.astype(np.int32)
    kv_len = np.array([S, 58], np.int32)
    kw = dict(causal=True, chunk=chunk)
    jkw = dict(kw, window=None if window is None else jnp.int32(window))
    if extra == "kv_len":
        kw["kv_len"] = torch.as_tensor(kv_len)
        jkw["kv_len"] = jnp.asarray(kv_len)
    want = j_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                     q_positions=jnp.asarray(q_pos),
                     kv_positions=jnp.asarray(kv_pos), **jkw)
    got = chunked_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                            q_positions=torch.as_tensor(q_pos),
                            kv_positions=torch.as_tensor(kv_pos),
                            window=window, **kw)
    _close(got, want, 2e-5)
    # the chunked oracle agrees with the flash plain version on a plain
    # causal prompt
    pos = torch.arange(S)[None].expand(B, S)
    tq = torch.as_tensor(rng.normal(size=(B, S, H, d)).astype(np.float32))
    o1 = chunked_attention(tq, torch.as_tensor(k), torch.as_tensor(v),
                           q_positions=pos, kv_positions=pos, chunk=chunk,
                           window=window)
    o2 = flash_attention_cuda(tq, torch.as_tensor(k), torch.as_tensor(v),
                              window=window or 0)
    torch.testing.assert_close(o1, o2, rtol=2e-5, atol=2e-5)


def test_wrappers_reject_other_devices_and_count_nothing_on_cpu():
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    q = torch.zeros(1, 4, 2, 16)
    flash_attention_cuda(q, q, q)
    decode_attention_cuda(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before
    m = q.to("meta")
    with pytest.raises(ValueError, match="need cuda"):
        flash_attention_cuda(m, m, m)
    with pytest.raises(ValueError, match="need cuda"):
        decode_attention_cuda(m[:, 0], m, m, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("bk,span,sms,want", [
    (16, 4096, 132, 8),  # starcoder2 serving: 4 sequences x 4 KV heads
    (512, 4096, 132, 1),  # decode_32k: 128 x 4, already 3.9 CTAs per SM
    (2, 100, 132, 2),  # a short cache: one 64-key block per split
    (1, 1000, 132, 16),  # 16 blocks of 64 keys
    (1, 100000, 132, 132),
])
def test_num_splits(bk, span, sms, want):
    assert num_splits(bk, span, sms) == want
