"""The port's audio-family training (whisper-medium) against the JAX
package's, on the CPU.

whisper-medium's reduced config (``cfg.reduced()``: 2 encoder and 4
decoder layers, d_model 128, 4 query heads over 2 KV heads in
self-attention, MHA in cross-attention, 32 frames) at float32, the same
weights in both packages drawn from one explicit seed through the port's
``init_model_params`` (the reference's ``init_params`` folds each leaf's
key with Python's salted ``hash``, so its weights change from process to
process), frames and batches from numpy seeds:

* ``forward_train`` against ``jax.value_and_grad`` of the reference's:
  loss and ce within rtol 1e-5, every gradient leaf within 1e-4 of its
  largest entry (``tests/test_torch_train.py``'s dense check);
* ``remat`` "full" and "dots" give ``none``'s loss and gradients bit for
  bit;
* the plain attention versions (``mha_ref`` with its log-sum-exp,
  ``mha_bwd_ref``) without the causal mask, at Sq = Skv and Sq != Skv,
  against ``jax.vjp`` of the reference's ``chunked_attention(causal=
  False)`` over ragged chunks; ``FlashAttentionFn`` and the tiled plain
  version of the wgmma backward (``tiled_bwd_ref``) on the same inputs;
* ``bwd_schedule`` at whisper's training shapes (the encoder's 1,500 over
  1,500 frames, the decoder's 448 tokens and a short 9 over 1,500 frames,
  no mask) against a brute-force enumeration of the visible pairs, its
  ragged last key block (1,500 = 11 x 128 + 92) and query step (1,500 =
  23 x 64 + 28) masked;
* one ``make_train_step`` step against the reference's: metrics, masters
  and moments;
* the reference's checkpoint of the audio training state resumed in the
  port for one more step, against the reference's own next step;
* a serving model's ``prefill`` records nothing for autograd and runs no
  remat and no log-sum-exp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models import forward_train as j_forward_train
from repro.models.attention import chunked_attention as j_chunked
from repro.train import checkpoint as j_ckpt
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref
from repro_torch.kernels.flash_attention.schedule import (
    bwd_schedule, tiled_bwd_ref)
from repro_torch.launch import train as t_train
from repro_torch.models import (
    attention, forward_train, init_model_params, init_serve_cache,
    opt_state_from_numpy, opt_state_to_numpy, params_from_numpy,
    params_to_numpy, prefill, transformer)
from repro_torch.models.attention import FlashAttentionFn
from repro_torch.models.model import _stacked_to_numpy, flat_leaves
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

ARCH = "whisper-medium"
KERNEL_BLOCKS = (128, 64, 128, 64)  # (kvb, qs, qr, ks) of the wgmma route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The reference's and the port's reduced config at float32."""
    kw = {"dtype": "float32", **kw}
    return tuple(m.get_config(ARCH).reduced().with_overrides(**kw)
                 for m in (j_configs, configs))


def seeded_tree(cfg, seed=0):
    """The reference's parameter tree (numpy) drawn from ``seed`` through
    the port's ``init_model_params``: the same weights in every process."""
    return params_to_numpy(init_model_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu",
        trainable=True))


def _batch(cfg, B=2, S=12, seed=0):
    """Tokens, labels (some left out of the loss) and frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs[0, :3] = -1
    frames = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(
        np.float32)
    return {"tokens": toks, "labels": labs, "frames": frames}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_leafwise(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest entry."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol


def _grads_numpy(model):
    """The gradients as the reference's tree (layer leaves stacked)."""
    return _stacked_to_numpy(model, [p.grad for p in flat_leaves(model)[0]])


# ---------------------------------------------------------------------------
# forward_train and remat
# ---------------------------------------------------------------------------

def test_forward_train_matches_value_and_grad():
    """Loss and ce within rtol 1e-5 and every gradient leaf (encoder,
    decoder with ``ln_x`` and ``xattn``, the untied head, the embedding)
    within 1e-4 of the reference's ``jax.value_and_grad``."""
    jcfg, cfg = _cfgs()
    tree = seeded_tree(cfg)
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_forward_train(p, _jb(batch), jcfg), has_aux=True)(
        _jtree(tree))
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    loss, m = forward_train(model, batch)
    loss.backward()
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key].detach()), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert float(m["aux"]) == 0.0
    got = _grads_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    assert {"enc_groups", "enc_ln_f", "dec_groups", "head"} <= set(got)
    assert {"ln_x", "xattn"} <= set(got["dec_groups"]["dense"])
    _close_leafwise(got, jg, 1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    """``full`` and ``dots`` give ``none``'s loss and every gradient bit
    for bit: the encoder, the cross K/V and the decoder under each."""
    _, cfg = _cfgs()
    tree = seeded_tree(cfg, seed=1)
    batch = _batch(cfg, seed=1)
    got = {}
    for r in ("none", remat):
        model = params_from_numpy(tree, cfg.with_overrides(remat=r),
                                  device="cpu", trainable=True)
        loss, _ = forward_train(model, batch)
        loss.backward()
        got[r] = (float(loss.detach()), [p.grad.clone()
                                for p in flat_leaves(model)[0]])
    assert got[remat][0] == got["none"][0]
    assert len(got[remat][1]) == len(got["none"][1])
    for a, b in zip(got[remat][1], got["none"][1]):
        assert torch.equal(a, b)


def test_serving_prefill_records_nothing(monkeypatch):
    """A serving model's parameters require no gradient: its ``prefill``
    (encoder included, grad mode on) records nothing for autograd and runs
    no layer under remat.  The encoder's and the cross-attention's calls
    go through ``FlashAttentionFn`` (kernel 3 with its log-sum-exp) in
    serving and training alike; the decoder's cached self-attention does
    not."""
    _, cfg = _cfgs()
    model = params_from_numpy(seeded_tree(cfg), cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    calls = {"checkpoint": 0, "lse": 0}
    orig_ckpt = transformer.checkpoint
    orig_flash = attention.flash_attention_cuda

    def ckpt(*a, **kw):
        calls["checkpoint"] += 1
        return orig_ckpt(*a, **kw)

    def flash(*a, **kw):
        calls["lse"] += bool(kw.get("return_lse"))
        return orig_flash(*a, **kw)

    monkeypatch.setattr(transformer, "checkpoint", ckpt)
    monkeypatch.setattr(attention, "flash_attention_cuda", flash)
    batch = _batch(cfg, B=2, S=5, seed=2)
    cache = init_serve_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert torch.is_grad_enabled()
    logits, cache = prefill(model, {"tokens": batch["tokens"],
                                    "frames": batch["frames"],
                                    "cache": cache})
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(t.grad_fn is None for t in cache["cross"])
    assert calls == {"checkpoint": 0,
                     "lse": cfg.encoder_layers + cfg.num_layers}
    calls["lse"] = 0
    # the same frames through a trainable model do record, under remat
    train = params_from_numpy(seeded_tree(cfg),
                              cfg.with_overrides(remat="full"),
                              device="cpu", trainable=True)
    loss, _ = forward_train(train, batch)
    assert loss.requires_grad
    assert calls["checkpoint"] == cfg.encoder_layers + cfg.num_layers
    assert calls["lse"] == cfg.encoder_layers + 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# the attention's plain versions without the mask and at Sq != Skv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Skv,H,K,d", [
    (2, 37, 37, 4, 4, 16),   # the encoder: Sq = Skv, no mask
    (2, 9, 50, 4, 4, 32),    # cross-attention: 9 tokens over 50 frames
    (1, 45, 20, 4, 2, 16),   # Sq > Skv, G = 2
])
def test_plain_attention_without_mask_matches_jax_vjp(B, Sq, Skv, H, K, d):
    """``mha_ref`` (output, and its log-sum-exp against the plain
    log-sum-exp) and ``mha_bwd_ref`` with ``causal=False`` against
    ``jax.vjp`` of the reference's ``chunked_attention(causal=False)`` in
    chunks of 16 (Skv not a multiple of the chunk), within 1e-5 (the
    dense backward's check in ``tests/test_torch_train.py``); then
    ``FlashAttentionFn`` (the autograd Function training runs) and
    ``tiled_bwd_ref`` at small blocks on the same inputs."""
    rng = np.random.default_rng(Sq * 100 + Skv)
    q, do = (rng.standard_normal((B, Sq, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, K, d)).astype(np.float32)
            for _ in range(2))
    qpos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Skv)[None], (B, Skv))

    def f(q, k, v):
        return j_chunked(q, k, v, q_positions=qpos, kv_positions=kpos,
                         causal=False, chunk=16)

    jo, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = mha_ref(tq, tk, tv, causal=False, return_lse=True, chunk=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", tq,
                     tk.repeat_interleave(H // K, dim=2)) / np.sqrt(d)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)
    got = mha_bwd_ref(tq, tk, tv, o, lse, tdo, causal=False, chunk=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    tiled = tiled_bwd_ref(tq, tk, tv, o, lse, tdo, causal=False, kvb=16,
                          qs=8, qr=16, ks=8)
    for a, b in zip(tiled, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    xq, xk, xv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = FlashAttentionFn.apply(xq, xk, xv, 0, False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-5)
    out.backward(tdo)
    for a, b in zip((xq.grad, xk.grad, xv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ---------------------------------------------------------------------------
# the wgmma backward's schedule at whisper's training shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (448, 1500), (9, 1500)])
def test_bwd_schedule_without_mask_at_whisper_shapes(Sq, Skv):
    """No mask: every (row, key) pair with row < Sq and key < Skv is
    visible.  Enumerated pair by pair, the blocks that hold a visible pair
    are exactly the visited ones, and a mask-free block is whole and all
    visible, so the ragged last key block (keys 1,408-1,499 of a 128-key
    block) and a ragged last query step (rows past Sq) always take the
    mask, as does every block of a query block past Sq."""
    kvb, qs, qr, ks = KERNEL_BLOCKS
    sch = bwd_schedule(Sq, Skv, causal=False, window=0, q_offset=0, kvb=kvb,
                       qs=qs, qr=qr, ks=ks)
    n_kb, n_qs = -(-Skv // kvb), -(-Sq // qs)
    n_qr, n_ks = -(-Sq // qr), -(-Skv // ks)
    assert sch.dkdv.shape == (n_kb, 4) and sch.dq.shape == (n_qr, 4)
    vis = np.zeros((n_qr * qr, n_kb * kvb), bool)
    vis[:Sq, :Skv] = True  # brute force: each pair from the definition
    for kb, (qb_lo, qb_hi, qf_lo, qf_hi) in enumerate(sch.dkdv):
        cols = vis[:, kb * kvb:(kb + 1) * kvb]
        seen = {i // qs for i in range(cols.shape[0]) if cols[i].any()}
        assert seen == set(range(qb_lo, qb_hi)) == set(range(n_qs))
        free = set(range(qf_lo, qf_hi))
        assert free == {qb for qb in range(n_qs)
                        if cols[qb * qs:(qb + 1) * qs].all()
                        and (qb + 1) * qs <= Sq}
        if (kb + 1) * kvb > Skv:  # the ragged last key block
            assert not free
    for qb, (jb_lo, jb_hi, jf_lo, jf_hi) in enumerate(sch.dq):
        rows = vis[qb * qr:(qb + 1) * qr]
        seen = {j // ks for j in range(Skv) if rows[:, j].any()}
        assert seen == set(range(jb_lo, jb_hi)) == set(range(n_ks))
        free = set(range(jf_lo, jf_hi))
        assert free == {j for j in range(n_ks)
                        if rows[:, j * ks:(j + 1) * ks].all()
                        and (j + 1) * ks <= Skv}
        assert (n_ks - 1 not in free) == bool(Skv % ks)
    assert sorted(sch.dkdv_order) == list(range(n_kb))
    assert list(sch.dq_order) == list(range(n_qr))[::-1]
    # whole blocks of 64 rows over whole blocks of 128 keys take no mask
    n_free = int((sch.dkdv[:, 3] - sch.dkdv[:, 2]).sum())
    assert n_free == (Skv // kvb) * (Sq // qs)


# ---------------------------------------------------------------------------
# the train step and a reference checkpoint
# ---------------------------------------------------------------------------

# eps = 1: the first Adam step moves each weight by ~lr g / (|g| + 1),
# smooth in g, so parameters compare at the gradients' precision
OKW = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1.0)


def _same_metrics(m, jm, rtol=1e-5):
    for key in ("loss", "ce", "aux", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=rtol, atol=1e-7, err_msg=key)


def _state_numpy(model, st):
    return {"params": params_to_numpy(model),
            "opt": opt_state_to_numpy(model, st)}


def test_train_step_matches_the_reference():
    """One ``make_train_step`` step with two micro-batches (the frames
    split with the tokens) against the reference's: the metrics within
    rtol 1e-5, the masters within rtol 1e-6 / atol 1e-7 (the tolerance
    ``test_adamw_update_matches_the_reference`` holds masters to), the
    moments within 1e-4 of each leaf's largest entry (first moments are
    the gradients scaled, so they differ as the gradients do)."""
    jcfg, cfg = _cfgs()
    tree = seeded_tree(cfg, seed=3)
    batch = _batch(cfg, B=4, S=10, seed=3)
    joc, oc = JOptConfig(**OKW), OptConfig(**OKW)
    jp = _jtree(tree)
    jp, js, jm = j_make_train_step(jcfg, oc=joc, accum_steps=2)(
        jp, j_init_opt(jp, joc), _jb(batch))
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    st = init_opt_state(flat_leaves(model)[0], oc)
    model, st, m = make_train_step(cfg, oc, accum_steps=2)(model, st, batch)
    _same_metrics(m, jm)
    got = _state_numpy(model, st)
    for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
    assert int(got["opt"]["step"]) == int(js["step"]) == 1
    for key in ("mu", "nu"):
        _close_leafwise(got["opt"][key], js[key], 1e-4)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains one step and checkpoints its whole audio state
    (``enc_groups``, ``enc_ln_f``, ``dec_groups`` with ``ln_x`` and
    ``xattn``, the untied ``head``, the moments and the step) with its own
    ``checkpoint.save``; the port restores it into the tree its
    ``train_loop`` resumes (``launch.train._like``) and takes the next
    step, whose metrics, masters and moments match the reference's own
    next step (as in :func:`test_train_step_matches_the_reference`)."""
    jcfg, cfg = _cfgs()
    tree = seeded_tree(cfg, seed=4)
    b0, b1 = _batch(cfg, seed=5), _batch(cfg, seed=6)
    joc, oc = JOptConfig(**OKW), OptConfig(**OKW)
    jstep = j_make_train_step(jcfg, oc=joc)
    jp = _jtree(tree)
    jp, js, _ = jstep(jp, j_init_opt(jp, joc), _jb(b0))
    j_ckpt.save(str(tmp_path), 1, {"params": jp, "opt": js})
    jp, js, jm = jstep(jp, js, _jb(b1))

    like = t_train._like(params_from_numpy(tree, cfg, device="cpu",
                                           trainable=True))
    state, step = t_ckpt.restore(str(tmp_path), like)
    assert step == 1
    model = params_from_numpy(state["params"], cfg, device="cpu",
                              trainable=True)
    st = opt_state_from_numpy(state["opt"], model, oc)
    assert st["step"] == 1
    model, st, m = make_train_step(cfg, oc)(model, st, b1)
    _same_metrics(m, jm)
    got = _state_numpy(model, st)
    for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
    assert int(got["opt"]["step"]) == int(js["step"]) == 2
    for key in ("mu", "nu"):
        _close_leafwise(got["opt"][key], js[key], 1e-4)
