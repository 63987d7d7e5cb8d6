"""The port's LM training modules against the JAX package's, on the CPU.

Same inputs, made from a seed with numpy, through the reference's
functions and the port's:

* data: ``batch_at`` bitwise; packed shards written by either package
  read by the other;
* optimizer: ``lr_at``; ``adamw_update`` on the same trees (params, mu, nu
  within rtol 1e-6; float32 and bfloat16 moments);
* compressors: TopK bitwise, int8 within 1e-7 relative, error feedback
  carried over three steps;
* ``lm_head_loss`` with labels of -1 and a padded vocab (loss and its
  gradients);
* the flash backward's plain version against ``jax.vjp`` of the
  reference's ``chunked_attention`` (float32, within 1e-5), and the
  autograd Function around the kernels on the CPU;
* ``forward_train``: loss (1e-5 relative) and gradients (1e-4 of each
  leaf's largest) against ``jax.value_and_grad(forward_train)`` for the
  four dense configs ``reduced()`` at float32; the three remat policies
  bitwise equal;
and the train step in ``test_torch_train_step.py``, the loop,
checkpoints and CLI in ``test_torch_train_loop.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as j_configs
from repro.dist.compression import Int8Compressor as JInt8
from repro.dist.compression import TopKCompressor as JTopK
from repro.dist.sharding import CPU_RUNTIME
from repro.dist.sharding import lm_head_loss as j_lm_head_loss
from repro.models import forward_train as j_forward_train
from repro.models import init_model_params as j_init
from repro.models.attention import chunked_attention as j_chunked
from repro.train import data as j_data
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.optimizer import lr_at as j_lr_at
from repro_torch import configs
from repro_torch.dist.compression import Int8Compressor, TopKCompressor
from repro_torch.dist.sharding import lm_head_loss
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref
from repro_torch.models import (
    forward_train, opt_state_from_numpy, opt_state_to_numpy,
    params_from_numpy, params_to_numpy)
from repro_torch.models.attention import FlashAttentionFn
from repro_torch.models.model import flat_leaves
from repro_torch.train import data
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, lr_at)

DENSE = ["starcoder2-7b", "glm4-9b", "minitron-4b", "mistral-large-123b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """The reference's and the port's config, reduced, float32."""
    kw = {"dtype": "float32", **kw}
    return (j_configs.get_config(arch).reduced().with_overrides(**kw),
            configs.get_config(arch).reduced().with_overrides(**kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs[0, :3] = -1  # positions left out of the loss
    return {"tokens": toks, "labels": labs}


def _grads_tree(model):
    """The port's gradients as the reference's tree (numpy)."""
    from repro_torch.models.model import _stacked_to_numpy

    params, _ = flat_leaves(model)
    return _stacked_to_numpy(model, [p.grad for p in params])


def _close_leafwise(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest entry."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(np.asarray(g, np.float32) - w).max()) <= tol


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_batch_at_is_the_references_bit_for_bit(seed):
    want = j_data.SyntheticLMDataset(512, 33, 5, seed=seed)
    got = data.SyntheticLMDataset(512, 33, 5, seed=seed)
    for step in (0, 1, 7, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_packed_shards_read_across_packages(tmp_path, writer):
    toks = np.random.default_rng(1).integers(0, 1000, 5000).astype(np.int32)
    (data if writer == "port" else j_data).write_packed_shards(
        str(tmp_path), toks, shard_tokens=700)
    a = data.PackedShardDataset(str(tmp_path), 16, 4)
    b = j_data.PackedShardDataset(str(tmp_path), 16, 4)
    for step in (0, 3, 40):
        x, y = a.batch_at(step), b.batch_at(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(x[k], y[k])
    it = a.iter_from(2)
    assert np.array_equal(next(it)["tokens"], b.batch_at(2)["tokens"])
    it.close()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_at_matches_the_schedule():
    for kw in ({}, {"warmup_steps": 7, "total_steps": 50, "lr": 1e-3},
               {"warmup_steps": 1, "total_steps": 4}):
        oc, joc = OptConfig(**kw), JOptConfig(**kw)
        n = min(joc.total_steps + 5, 200)
        got = np.array([lr_at(s, oc) for s in range(n)])
        want = np.array([float(j_lr_at(jnp.asarray(s), joc))
                         for s in range(n)])
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(state_dtype):
    rng = np.random.default_rng(2)
    shapes = [(3, 5), (7,), (2, 4, 3)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype, clip_norm=0.5)
    oc, joc = OptConfig(**kw), JOptConfig(**kw)
    jp = [jnp.asarray(p) for p in ps]
    jstate = j_init_opt(jp, joc)
    tp = [torch.tensor(p) for p in ps]
    tstate = init_opt_state(tp, oc)
    for it in range(3):  # three steps: moments and schedule carried
        g = [x * (1 + it) for x in gs]
        jp, jstate, jm = j_adamw(jp, [jnp.asarray(x) for x in g], jstate,
                                 joc)
        tm = adamw_update(tp, [torch.tensor(x) for x in g], tstate, oc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert tstate["step"] == int(jstate["step"])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for key in ("mu", "nu"):
            for a, b in zip(tstate[key], jstate[key]):
                assert str(a.dtype).endswith(state_dtype)
                np.testing.assert_allclose(
                    a.float().numpy(), np.asarray(b, np.float32),
                    rtol=1e-6 if state_dtype == "float32" else 1e-2,
                    atol=1e-12)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_compressors_with_error_feedback(kind):
    rng = np.random.default_rng(3)
    shapes = [(40, 6), (17,), (3, 9, 5)]
    if kind == "topk":
        port, ref = TopKCompressor(0.1), JTopK(0.1)
    else:
        port, ref = Int8Compressor(), JInt8()
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    grads[0][0][0, :4] = 2.5  # ties at the top-k threshold are all kept
    ts = port.init_state([torch.zeros(s) for s in shapes])
    js = ref.init_state([jnp.zeros(s) for s in shapes])
    for g in grads:
        tout, ts, tm = port.apply([torch.tensor(x) for x in g], ts)
        jout, js, jm = ref.apply([jnp.asarray(x) for x in g], js)
        for a, b in zip(tout + ts, list(jout) + list(js)):
            if kind == "topk":
                assert np.array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-7, atol=1e-7 * float(
                                               np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(float(tm["comp_err_norm"]),
                                   float(jm["comp_err_norm"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_lm_head_loss_masks_labels_and_padded_vocab():
    rng = np.random.default_rng(4)
    B, S, d, Vp, V = 2, 7, 16, 256, 200
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    head = rng.standard_normal((Vp, d)).astype(np.float32) * 0.3
    labels = rng.integers(0, V + 40, (B, S)).astype(np.int32)  # some >= V
    labels[0, :2] = -1
    labels[1, 5] = -1

    def j_loss(x, head):
        return j_lm_head_loss(x, head, jnp.asarray(labels), CPU_RUNTIME,
                              valid_vocab=V)

    want, (jgx, jgh) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    got = lm_head_loss(tx, th, torch.tensor(labels), valid_vocab=V)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,K,d,window", [
    (37, 4, 4, 16, 0),    # G = 1
    (50, 4, 2, 32, 9),    # G = 2, windowed
    (41, 8, 2, 16, 0),    # G = 4
    (33, 4, 1, 32, 12),   # G = 4, windowed
])
def test_mha_bwd_ref_matches_jax_vjp_of_chunked_attention(S, H, K, d,
                                                          window):
    rng = np.random.default_rng(S)
    B = 2
    q, do = (rng.standard_normal((B, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, K, d)).astype(np.float32)
            for _ in range(2))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    def f(q, k, v):  # chunks of 16: S is not a multiple of the chunk
        return j_chunked(q, k, v, q_positions=pos, kv_positions=pos,
                         causal=True, window=window or None, chunk=16)

    jo, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    o, lse = mha_ref(tq, tk, tv, causal=True, window=window,
                     return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    got = mha_bwd_ref(tq, tk, tv, o, lse, torch.tensor(do), causal=True,
                      window=window, chunk=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the autograd Function on CPU tensors runs both plain versions
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = FlashAttentionFn.apply(tq, tk, tv, window)
    out.backward(torch.tensor(do))
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_mha_ref_lse_is_the_masked_logsumexp():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((1, 6, 2, 16)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 9, 1, 16)), dtype=torch.float32)
    _, lse = mha_ref(q, k, k, causal=True, window=2, q_offset=10,
                     return_lse=True)
    # rows at positions 10..15, window 2, keys 0..8: no row sees a key
    assert torch.isinf(lse).all() and (lse < 0).all()
    _, lse = mha_ref(q, k, k, causal=True, window=0, q_offset=3,
                     return_lse=True)
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / 4.0
    qpos = torch.arange(6)[:, None] + 3
    s = s.masked_fill(torch.arange(9)[None] > qpos, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# forward_train and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_value_and_grad(arch):
    jcfg, cfg = _cfgs(arch)
    params = j_init(jax.random.key(0), jcfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_forward_train(p, jb, jcfg), has_aux=True)(params)
    model = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
    loss, m = forward_train(model, batch)
    loss.backward()
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7)
    _close_leafwise(jax.tree.leaves(_grads_tree(model)),
                    jax.tree.leaves(_np_tree(jg)), 1e-4)


def test_remat_policies_give_the_same_gradients():
    _, cfg = _cfgs("starcoder2-7b")
    jparams = _np_tree(j_init(jax.random.key(1), _cfgs("starcoder2-7b")[0]))
    batch = _batch(cfg, seed=1)
    got = {}
    for remat in ("none", "full", "dots"):
        c = cfg.with_overrides(remat=remat)
        model = params_from_numpy(jparams, c, device="cpu", trainable=True)
        loss, _ = forward_train(model, batch)
        loss.backward()
        got[remat] = (float(loss), [p.grad.clone()
                                    for p in flat_leaves(model)[0]])
    for remat in ("full", "dots"):
        assert got[remat][0] == got["none"][0]
        for a, b in zip(got[remat][1], got["none"][1]):
            assert torch.equal(a, b), remat


def test_params_and_opt_state_round_trip_the_reference_tree():
    jcfg, cfg = _cfgs("glm4-9b")
    params = _np_tree(j_init(jax.random.key(2), jcfg))
    model = params_from_numpy(params, cfg, device="cpu", trainable=True)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(params)))
    joc = JOptConfig()
    jstate = _np_tree(j_init_opt(params, joc))
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.ndim else np.int32(5), jstate)
    st = opt_state_from_numpy(jstate, model, OptConfig())
    assert st["step"] == 5
    back = opt_state_to_numpy(model, st)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(jstate)))
