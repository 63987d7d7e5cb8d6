"""The port's train step against the JAX package's ``make_train_step``, on
the CPU, from the same weights (the reference's ``init_model_params``
tree) and batches at the reduced float32 configs: metrics, parameters and
moments after two steps; the NaN guard (state bitwise unchanged, the
reference skipping the same step); accumulation of two micro-batches at
the gradient level (ratio under 1e-4, as ``tests/test_train.py`` holds
the reference); ``cast_params_once`` raising until the dry-run that uses
it is ported; int8 and top-k compression through the step against the
reference's; an update that fails after its first in-place write.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as j_configs
from repro.dist.compression import Int8Compressor as JInt8
from repro.dist.compression import TopKCompressor as JTopK
from repro.models import init_model_params as j_init
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.dist.compression import Int8Compressor, TopKCompressor
from repro_torch.models import (opt_state_to_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.model import flat_leaves
from repro_torch.train import data
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import init_comp_state, make_train_step

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
# the train step
# ---------------------------------------------------------------------------

class _Recorder(Int8Compressor):
    """Identity round trip that records the gradients it is given."""

    def __init__(self):
        self.seen = []

    def _roundtrip(self, t):
        self.seen.append(t.clone())
        return t


def _step_pair(arch="glm4-9b", **kw):
    jcfg, cfg = _cfgs(arch)
    params = j_init(jax.random.key(3), jcfg)
    # eps = 1: the first Adam step moves each weight by ~lr g / (|g| + 1),
    # smooth in g, so parameters compare at the gradients' precision
    okw = dict(lr=1e-2, warmup_steps=1, total_steps=5, eps=1.0)
    oc, joc = OptConfig(**okw), JOptConfig(**okw)
    batch = _batch(cfg, B=4, S=16, seed=3)
    model = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
    state = init_opt_state(flat_leaves(model)[0], oc)
    return jcfg, cfg, params, oc, joc, batch, model, state


def test_train_step_matches_the_reference():
    jcfg, cfg, params, oc, joc, batch, model, state = _step_pair()
    jstep = j_make_train_step(jcfg, oc=joc)
    jp, js = params, j_init_opt(params, joc)
    step = make_train_step(cfg, oc)
    for _ in range(2):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        model, state, m = step(model, state, batch)
        for key in ("loss", "ce", "aux", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7)
    _close_leafwise(jax.tree.leaves(params_to_numpy(model)),
                    jax.tree.leaves(_np_tree(jp)), 1e-5)
    got = opt_state_to_numpy(model, state)
    assert int(got["step"]) == int(js["step"]) == 2
    for key in ("mu", "nu"):
        _close_leafwise(jax.tree.leaves(got[key]),
                        jax.tree.leaves(_np_tree(js[key])), 1e-4)


def test_nan_guard_leaves_the_state_bitwise():
    jcfg, cfg, params, oc, joc, batch, model, state = _step_pair()
    step = make_train_step(cfg, oc)
    model, state, _ = step(model, state, batch)  # moments not zero
    with torch.no_grad():
        for p in flat_leaves(model)[0]:
            p.fill_(float("nan"))
    before = [t.clone() for t in flat_leaves(model)[0] + state["mu"]
              + state["nu"]]
    model, state, m = step(model, state, batch)
    assert float(m["skipped"]) == 1.0
    assert not np.isfinite(float(m["grad_norm"]))
    assert state["step"] == 1
    after = flat_leaves(model)[0] + state["mu"] + state["nu"]
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(before, after))
    # the reference skips the same poisoned step
    jstep = j_make_train_step(jcfg, oc=joc)
    nan = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan), params)
    _, _, jm = jstep(nan, j_init_opt(params, joc),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    assert int(jm["skipped"]) == 1


def test_grad_accumulation_equivalence():
    """accum_steps=2 over a batch of 4 equals one pass over it, at the
    gradient level (the gradients the step hands its compressor).  The
    batch is the data pipeline's, every label counted, as in the
    reference's test (with masked labels a mean over each micro-batch is
    not the mean over the batch)."""
    _, cfg, _, oc, _, _, model, state = _step_pair()
    batch = data.SyntheticLMDataset(cfg.vocab_size, 16, 4).batch_at(0)
    got = {}
    for accum in (1, 2):
        rec = _Recorder()
        step = make_train_step(cfg, oc, accum_steps=accum, compressor=rec)
        m = params_from_numpy(params_to_numpy(model), cfg, device="cpu",
                              trainable=True)
        st = init_opt_state(flat_leaves(m)[0], oc)
        _, _, met, _ = step(m, st, batch, init_comp_state(m))
        got[accum] = (torch.cat([g.reshape(-1) for g in rec.seen]),
                      float(met["loss"]))
    g1, g2 = got[1][0], got[2][0]
    assert float((g1 - g2).norm() / g1.norm()) < 1e-4
    np.testing.assert_allclose(got[2][1], got[1][1], rtol=1e-5)


def test_cast_params_once_and_compressors_through_the_step():
    jcfg, cfg, params, oc, joc, batch, model, state = _step_pair(
        "starcoder2-7b")
    # cast_params_once comes with jit_train_step and the dry-run, its only
    # caller in the reference (ROADMAP item 11); until then it raises
    with pytest.raises(NotImplementedError, match="item 11"):
        make_train_step(cfg, oc, cast_params_once=True)
    for name, jc, tc in (("int8", JInt8(), Int8Compressor()),
                         ("topk", JTopK(0.05), TopKCompressor(0.05))):
        jstep = j_make_train_step(jcfg, oc=joc, compressor=jc)
        jp, js, jm, jcs = jstep(params, j_init_opt(params, joc),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jc.init_state(params))
        m = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
        st = init_opt_state(flat_leaves(m)[0], oc)
        m, st, met, cs = make_train_step(cfg, oc, compressor=tc)(
            m, st, batch, init_comp_state(m))
        for key in ("loss", "grad_norm", "comp_err_norm"):
            np.testing.assert_allclose(float(met[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=name)
        assert len(cs) == len(jax.tree.leaves(jcs))


def test_update_that_fails_midway_reports_a_partial_write():
    """adamw_update writes leaf by leaf: a failure before the first write
    re-raises as it was with the state bitwise unchanged; a failure after
    it raises PartialUpdateError (the train loop does not retry it)."""
    from repro_torch.train.optimizer import PartialUpdateError, adamw_update

    _, cfg, _, oc, _, _, model, state = _step_pair()
    params, decay = flat_leaves(model)
    grads = [torch.full_like(p, 0.01) for p in params]
    before = [t.clone() for t in params + state["mu"] + state["nu"]]
    bad = list(grads)
    bad[0] = torch.zeros(3)  # no leaf is this shape
    with pytest.raises(RuntimeError) as e:
        adamw_update(params, bad, state, oc, decay=decay)
    assert not isinstance(e.value, PartialUpdateError)
    assert state["step"] == 0
    assert all(torch.equal(a, b) for a, b in zip(
        before, params + state["mu"] + state["nu"]))
    bad = list(grads)
    bad[2] = torch.zeros(3)
    with pytest.raises(PartialUpdateError, match="leaf 2 .* leaves 0..1"):
        adamw_update(params, bad, state, oc, decay=decay)
    assert state["step"] == 0
    assert not torch.equal(params[0], before[0])  # written
    assert torch.equal(params[2], before[2])
