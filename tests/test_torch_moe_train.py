"""The port's MoE training path against the JAX package's, on the CPU.

dbrx-132b and llama4-maverick-400b-a17b at their reduced widths
(``cfg.reduced()``: d_model 128, 4 experts, top-k at most 2), llama4
with its shared expert switched on again, float32 unless a test says
otherwise, the same weights (the reference's ``init_model_params`` tree)
and batches in both packages:

* a train step with two micro-batches (``accum_steps=2``) against the
  reference's ``make_train_step``: metrics, parameters and moments within
  1e-4, on a batch whose micro-batches drop other entries than one pass
  over the whole batch would (capacity is per micro-batch);
* ``remat`` none, full and dots: the same loss and gradients, and the
  reference's under ``dots``;
* under ``dots``, an op count: the experts' ``bmm``s run again in the
  backward, the ``mm``s do not (the reference's
  ``checkpoint_dots_with_no_batch_dims``); under ``full`` both do;
* bfloat16 moments through a MoE step against the reference's;
* a MoE ``train_loop`` checkpoint written by the reference, resumed by
  the port, the losses within 1e-4 of the reference's uninterrupted run;
* ``python -m repro_torch.launch.train --arch dbrx-132b --reduced
  --device cpu`` printing the reference's lines.
"""
import collections
import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as j_configs
import repro.launch.train as j_train
from repro.models import forward_train as j_forward_train
from repro.models import init_model_params as j_init
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.launch import train as t_train
from repro_torch.models import (forward_train, moe, opt_state_to_numpy,
                                params_from_numpy, params_to_numpy)
from repro_torch.models.model import _stacked_to_numpy, flat_leaves
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, capacity_factor=None, **kw):
    """The reference's and the port's reduced config (float32 unless
    ``dtype`` is given), with the full config's shared expert."""
    kw = {"dtype": "float32", **kw}
    out = []
    for mod in (j_configs, configs):
        full = mod.get_config(arch)
        c = full.reduced()
        c = c.with_overrides(moe=dataclasses.replace(
            c.moe, shared_expert=full.moe.shared_expert,
            capacity_factor=capacity_factor or c.moe.capacity_factor), **kw)
        out.append(c)
    return tuple(out)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs[0, :3] = -1  # positions left out of the loss
    return {"tokens": toks, "labels": labs}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_leafwise(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest entry."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol


@contextlib.contextmanager
def _dispatches():
    """Every dispatch's keep mask (T, k) while the block runs."""
    got = []
    orig = moe._dispatch

    def rec(x, top_g, top_i, num_experts, capacity):
        out = orig(x, top_g, top_i, num_experts, capacity)
        got.append(out[2].detach().clone())
        return out

    moe._dispatch = rec
    try:
        yield got
    finally:
        moe._dispatch = orig


# eps = 1: the first Adam step moves each weight by ~lr g / (|g| + 1),
# smooth in g, so parameters compare at the gradients' precision
OKW = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1.0)
CF_DROPS = 0.5  # a capacity factor at which every micro-batch drops


def _step_pair(arch, state_dtype="float32", accum_steps=1, steps=2,
               seed=3, capacity_factor=None):
    """``steps`` train steps of the reference and of the port from the
    same weights on the same batch.  Returns (reference params, opt state
    and metrics; port model, opt state and metrics)."""
    ref, cfg = _cfgs(arch, capacity_factor)
    params = j_init(jax.random.key(seed), ref)
    okw = dict(OKW, state_dtype=state_dtype)
    joc, oc = JOptConfig(**okw), OptConfig(**okw)
    batch = _batch(cfg, seed=seed)
    jstep = j_make_train_step(ref, oc=joc, accum_steps=accum_steps)
    jp, js = params, j_init_opt(params, joc)
    model = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
    st = init_opt_state(flat_leaves(model)[0], oc)
    step = make_train_step(cfg, oc, accum_steps=accum_steps)
    for _ in range(steps):
        jp, js, jm = jstep(jp, js, _jb(batch))
        model, st, m = step(model, st, batch)
    return (jp, js, jm), (model, st, m)


def _same_metrics(m, jm, rtol=1e-4):
    for key in ("loss", "ce", "aux", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=rtol, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("arch", MOE)
def test_accumulated_step_matches_the_reference(arch):
    """Two steps with ``accum_steps=2``: metrics, parameters and moments
    within 1e-4 of the reference's (each leaf against its largest entry).
    The capacity is per micro-batch (the reference scans micro-batches):
    in layer 0, whose input is the embedding whatever the batching, the
    two micro-batches drop entries, and other ones than a single pass
    over the four sequences would.  A capacity factor of 0.5 makes both
    micro-batches drop (at the configs' 1.25, top 1 over 4 experts leaves
    room for every entry)."""
    ref, cfg = _cfgs(arch, CF_DROPS)
    params = j_init(jax.random.key(3), ref)
    model = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
    batch = _batch(cfg, seed=3)
    n_moe = cfg.num_layers // cfg.moe.moe_every
    with _dispatches() as whole, torch.no_grad():
        forward_train(model, batch)
    with _dispatches() as micro:
        make_train_step(cfg, OptConfig(**OKW), accum_steps=2)(
            model, init_opt_state(flat_leaves(model)[0], OptConfig(**OKW)),
            batch)
    assert len(whole) == n_moe and len(micro) == 2 * n_moe
    halves = [micro[0], micro[n_moe]]  # layer 0 of each micro-batch
    assert all(bool((h == 0).any()) for h in halves)
    assert not torch.equal(torch.cat(halves), whole[0])

    (jp, js, jm), (model, st, m) = _step_pair(arch, accum_steps=2,
                                              capacity_factor=CF_DROPS)
    _same_metrics(m, jm)
    _close_leafwise(params_to_numpy(model), _np_tree(jp), 1e-4)
    got = opt_state_to_numpy(model, st)
    assert int(got["step"]) == int(js["step"]) == 2
    for key in ("mu", "nu"):
        _close_leafwise(got[key], _np_tree(js[key]), 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """``forward_train`` and its backward under ``none``, ``full`` and
    ``dots``: the loss and every gradient within 1e-6 of ``none``'s, and
    within 1e-4 of the reference's ``jax.value_and_grad`` under ``dots``
    (``checkpoint_dots_with_no_batch_dims``)."""
    ref, cfg = _cfgs(arch)
    params = j_init(jax.random.key(5), ref)
    batch = _batch(cfg, B=2, S=24, seed=6)
    out = {}
    for r in ("none", "full", "dots"):
        model = params_from_numpy(_np_tree(params),
                                  cfg.with_overrides(remat=r), device="cpu",
                                  trainable=True)
        loss, m = forward_train(model, batch)
        loss.backward()
        out[r] = ({k: float(v) for k, v in m.items()}, _stacked_to_numpy(
            model, [p.grad for p in flat_leaves(model)[0]]))
    for r in ("full", "dots"):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(out[r][0][k], out["none"][0][k],
                                       rtol=1e-6)
        _close_leafwise(out[r][1], out["none"][1], 1e-6)
    (_, jm), jg = jax.value_and_grad(
        lambda p: j_forward_train(p, _jb(batch),
                                  ref.with_overrides(remat="dots")),
        has_aux=True)(params)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(out["dots"][0][k], float(jm[k]),
                                   rtol=1e-5)
    _close_leafwise(out["dots"][1], _np_tree(jg), 1e-4)


class _OpCount(TorchDispatchMode):
    """Counts the experts' forward ``bmm``s (by their two operand shapes)
    and the ``mm``s (``addmm`` too) dispatched while it is on."""

    def __init__(self, expert_shapes):
        super().__init__()
        self.expert = expert_shapes
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func is aten.bmm.default and (
                tuple(args[0].shape), tuple(args[1].shape)) in self.expert:
            self.n["expert_bmm"] += 1
        elif func in (aten.mm.default, aten.addmm.default):
            self.n["mm"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", MOE)
def test_dots_recomputes_the_expert_bmms_and_not_the_mms(arch):
    """What the backward runs beyond ``remat="none"``'s is what the
    policy recomputed: under ``dots`` the experts' two ``bmm``s a MoE
    layer (their expert axis a batch dimension) and no ``mm`` (the
    products without a batch dimension are kept); under ``full`` the
    ``mm``s as well."""
    ref, cfg = _cfgs(arch)
    model = params_from_numpy(_np_tree(j_init(jax.random.key(7), ref)), cfg,
                              device="cpu", trainable=True)
    B, S = 1, 48
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    C = moe._capacity(B * S, cfg)
    expert = {((E, C, d), (E, d, 2 * f)), ((E, C, f), (E, f, d))}
    batch = _batch(cfg, B=B, S=S, seed=8)
    params = flat_leaves(model)[0]
    fwd, bwd = {}, {}
    for r in ("none", "dots", "full"):
        model.cfg = cfg.with_overrides(remat=r)
        with _OpCount(expert) as f_count:
            loss, _ = forward_train(model, batch)
        with _OpCount(expert) as b_count:
            torch.autograd.grad(loss, params)
        fwd[r], bwd[r] = f_count.n, b_count.n
    n_moe = cfg.num_layers // cfg.moe.moe_every
    assert all(fwd[r]["expert_bmm"] == 2 * n_moe for r in fwd)
    assert bwd["none"]["expert_bmm"] == 0
    again = {r: {k: bwd[r][k] - bwd["none"][k] for k in ("expert_bmm", "mm")}
             for r in ("dots", "full")}
    assert again["dots"] == {"expert_bmm": 2 * n_moe, "mm": 0}
    assert again["full"]["expert_bmm"] == 2 * n_moe
    # full reruns the layers' mms (but a layer's last, whose output no
    # backward needs: the recompute stops early)
    assert again["full"]["mm"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_bf16_moments_through_a_moe_step(arch):
    """``OptConfig(state_dtype="bfloat16")``, as the reference's cells of
    these models, two steps: metrics and parameters within 1e-4 of the
    reference's; the moments held in bfloat16 and within 1e-4 of the
    leaf's largest plus two bfloat16 steps (2^-6 of the entry) of the
    reference's: each step rounds the moments once, and a float32 value a
    rounding apart may round to the neighbouring bfloat16."""
    (jp, js, jm), (model, st, m) = _step_pair(arch,
                                              state_dtype="bfloat16")
    _same_metrics(m, jm)
    _close_leafwise(params_to_numpy(model), _np_tree(jp), 1e-4)
    assert all(t.dtype == torch.bfloat16 for t in st["mu"] + st["nu"])
    got = opt_state_to_numpy(model, st)
    for key in ("mu", "nu"):
        for g, w in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(_np_tree(js[key]))):
            w = np.asarray(w, np.float32)
            assert g.shape == w.shape
            tol = (2.0 ** -6 * np.maximum(np.abs(g), np.abs(w))
                   + 1e-4 * float(np.abs(w).max()))
            assert bool((np.abs(g - w) <= tol).all())


def _losses(out):
    return {h["step"]: h["loss"] for h in out["history"]}


@pytest.mark.parametrize("arch", MOE)
def test_reference_checkpoint_resumes_in_the_port(tmp_path, arch):
    """The reference's ``train_loop`` (two micro-batches, bfloat16
    moments) checkpoints after two steps; the port resumes it for two
    more, whose losses equal the reference's uninterrupted run within
    1e-4."""
    ref, cfg = _cfgs(arch)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4,
               state_dtype="bfloat16")
    run = dict(global_batch=4, seq_len=16, log_every=1, ckpt_every=2,
               accum_steps=2)
    whole = j_train.train_loop(ref, steps=4, oc=JOptConfig(**okw),
                               ckpt_dir=str(tmp_path / "whole"), **run)
    j_train.train_loop(ref, steps=2, oc=JOptConfig(**okw),
                       ckpt_dir=str(tmp_path / "split"), **run)
    resumed = t_train.train_loop(cfg, steps=4, device="cpu",
                                 oc=OptConfig(**okw),
                                 ckpt_dir=str(tmp_path / "split"), **run)
    assert resumed["resumed_from"] == 2
    want, got = _losses(whole), _losses(resumed)
    assert sorted(got) == [2, 3]
    for s in (2, 3):
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4)
    assert all(t.dtype == torch.bfloat16
               for t in resumed["opt_state"]["mu"])


def _mask(text):
    """The lines with their numbers masked (weights and timings differ)."""
    return [re.sub(r"[-+]?\d+\.\d+(e[-+]\d+)?", "<n>", ln)
            for ln in text.splitlines()]


def test_train_cli_runs_dbrx_reduced_with_the_reference_lines(
        capsys, monkeypatch):
    args = ["--arch", "dbrx-132b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "16", "--accum", "2"]
    monkeypatch.setattr("sys.argv", ["train"] + args)
    j_train.main()
    want = capsys.readouterr().out
    t_train.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _mask(got) == _mask(want)
    assert got.splitlines()[-1].startswith("[train] done: first loss")
