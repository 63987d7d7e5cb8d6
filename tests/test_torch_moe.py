"""The port's MoE family against the JAX package's, on the CPU.

Same inputs, made from a seed with numpy, through the reference's
functions and the port's, for dbrx-132b and llama4-maverick-400b-a17b at
their reduced widths (``cfg.reduced()``: d_model 128, 4 experts, top-k
at most 2), llama4 with its shared expert switched on again
(``reduced()`` rebuilds ``MoEConfig`` without it):

* ``_route``: gates within 1e-6, the top-k experts equal wherever the
  k-th gate leads the (k+1)-th by more than 1e-5, and on exact ties the
  lower expert index first, as ``jax.lax.top_k``;
* ``_dispatch``, ``_expert_ffn`` and ``_combine`` fed the reference's
  routing, within 1e-5 at float32; ``_capacity`` over a grid;
  ``_aux_loss``;
* ``moe_apply_local`` within 1e-5 at float32 and 5e-2 at bfloat16, with no
  drops (``capacity_factor=64``) and with a capacity that drops;
* prefill and decode at float32 (logits and both parts of the nested
  cache within 1e-4), ``BatchedServer`` tokens, ``forward_train``'s
  loss, ce and aux within 1e-5 and its gradients, the parameter and
  optimizer trees across the packages, one train step with a compressor,
  and ``python -m repro_torch.launch.serve --reduced --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
import repro.launch.serve as j_serve
import repro.models.moe as j_moe
from repro.models import decode_step as j_decode_step
from repro.models import forward_train as j_forward_train
from repro.models import init_model_params as j_init
from repro.models import init_serve_cache as j_init_cache
from repro.models import model_schema as j_model_schema
from repro.models import prefill as j_prefill
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt
from repro_torch import configs
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import (
    decode_step, forward_train, init_model_params, init_serve_cache,
    model_schema, opt_state_from_numpy, opt_state_to_numpy,
    params_from_numpy, params_to_numpy, prefill)
from repro_torch.models import moe
from repro_torch.models.layers import ParamDef
from repro_torch.models.model import flat_leaves, stack_dims, train_leaves
from repro_torch.train.optimizer import OptConfig

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """The reference's and the port's reduced config (float32 unless
    ``dtype`` is given), with the full config's shared expert."""
    kw = {"dtype": "float32", **kw}
    out = []
    for mod in (j_configs, configs):
        full = mod.get_config(arch)
        c = full.reduced()
        moe_kw = {"shared_expert": full.moe.shared_expert}
        if "capacity_factor" in kw:
            moe_kw["capacity_factor"] = kw["capacity_factor"]
        c = c.with_overrides(
            moe=dataclasses.replace(c.moe, **moe_kw),
            **{k: v for k, v in kw.items() if k != "capacity_factor"})
        out.append(c)
    return tuple(out)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _moe_params(cfg, seed=0, router_scale=1.0):
    """One MoE layer's parameters (numpy float32), router scaled so that
    routing is decided by clear margins."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, pd in moe.moe_schema(cfg).items():
        fan = pd.shape[-2]
        out[name] = (rng.standard_normal(pd.shape) / np.sqrt(fan)).astype(
            np.float32)
    out["router"] *= router_scale
    return out


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# configs and schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_model_schema_matches_reference(arch):
    ref, cfg = (j_configs.get_config(arch), configs.get_config(arch))
    for r, c in ((ref, cfg), _cfgs(arch)):
        want = j_model_schema(r)
        got = model_schema(c)
        assert jax.tree.structure(
            jax.tree.map(lambda d: d.shape, got,
                         is_leaf=lambda x: isinstance(x, ParamDef))) == \
            jax.tree.structure(jax.tree.map(lambda d: d.shape, want))
        flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
            x, ParamDef))
        flat_want = jax.tree.leaves(want, is_leaf=lambda x: hasattr(
            x, "shape") and hasattr(x, "init"))
        assert [(d.shape, d.axes, d.init, d.scale) for d in flat_got] == \
            [(d.shape, d.axes, d.init, d.scale) for d in flat_want]


# ---------------------------------------------------------------------------
# the layer's parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch):
    ref, cfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    jp, tp = _both(_moe_params(cfg, 1))
    jg, ji, jgates = j_moe._route(jp, jnp.asarray(x), ref)
    tg, ti, tgates = moe._route(tp, _t(x), cfg)
    assert tg.dtype == tgates.dtype == torch.float32
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    k = cfg.moe.top_k
    srt = -np.sort(-np.asarray(jgates), axis=-1)
    clear = srt[:, k - 1] - srt[:, k] > 1e-5
    assert clear.sum() > 48
    assert np.array_equal(ti.numpy()[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("arch", MOE)
def test_route_takes_the_lower_index_on_ties(arch):
    """Exact ties: all gates equal (a zero router), and a tie between two
    experts over the others; both packages take the lower index first."""
    ref, cfg = _cfgs(arch)
    k, E, d = cfg.moe.top_k, cfg.moe.num_experts, cfg.d_model
    x = np.zeros((3, d), np.float32)
    x[1, 0] = 1.0
    x[2, 1] = 1.0
    router = np.zeros((d, E), np.float32)
    router[0, [E - 1, 1]] = 5.0  # token 1: experts 1 and E-1 tie on top
    router[1, [2, 3]] = 5.0  # token 2: experts 2 and 3 tie on top
    jg, ji, _ = j_moe._route({"router": jnp.asarray(router)},
                             jnp.asarray(x), ref)
    tg, ti, _ = moe._route({"router": _t(router)}, _t(x), cfg)
    want = np.array([[0, 1], [1, E - 1], [2, 3]])[:, :k]
    assert np.array_equal(ti.numpy(), want)
    assert np.array_equal(np.asarray(ji), want)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    np.testing.assert_allclose(tg.numpy().sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("cf", [64.0, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_ffn_combine_match_reference(arch, cf):
    """The three stages fed the reference's routing (float32, 1e-5); at
    capacity factor 0.5 entries drop and the dropped ones add nothing."""
    ref, cfg = _cfgs(arch, capacity_factor=cf)
    rng = np.random.default_rng(2)
    T, E = 96, cfg.moe.num_experts
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    jp, tp = _both(_moe_params(cfg, 2, router_scale=8.0))
    jg, ji, _ = j_moe._route(jp, jnp.asarray(x), ref)
    C = j_moe._capacity(T, ref)
    assert moe._capacity(T, cfg) == C
    jbuf, jslot, jkeep, jtok = j_moe._dispatch(jnp.asarray(x), jg, ji, E, C)
    tg, ti = _t(jg), _t(ji)
    tbuf, tslot, tkeep, ttok = moe._dispatch(_t(x), tg, ti, E, C)
    assert tuple(tbuf.shape) == (E, C, cfg.d_model)
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=0,
                               atol=1e-5)
    assert np.array_equal(tslot.numpy(), np.asarray(jslot))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    dropped = int((np.asarray(jkeep) == 0).sum())
    assert (dropped > 0) == (cf < 1)
    jout = j_moe._expert_ffn(jp["wi"], jp["wo"], jbuf, ref)
    tout = moe._expert_ffn(tp["wi"], tp["wo"], _t(jbuf), cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    jy = j_moe._combine(jout, jg, ji, jslot, jkeep, T)
    ty = moe._combine(_t(jout), tg, ti, _t(jslot), _t(jkeep), T)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_capacity_matches_reference_over_a_grid():
    ref, cfg = _cfgs("dbrx-132b")
    n = 0
    for T in (1, 4, 7, 32, 255, 32768):
        for k in (1, 2, 4):
            for E in (4, 16, 128):
                for cf in (0.01, 0.5, 1.0, 1.25, 2.0, 64.0):
                    mk = dict(num_experts=E, top_k=k, capacity_factor=cf)
                    r = ref.with_overrides(moe=dataclasses.replace(ref.moe,
                                                                   **mk))
                    c = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                                   **mk))
                    got = moe._capacity(T, c)
                    assert got == j_moe._capacity(T, r)
                    assert got >= 8 and got % 8 == 0
                    n += 1
    assert n == 324
    # the card's shapes: prefill of 4 x 8,192 tokens and decode at B = 4
    for arch, prefill_c in (("dbrx-132b", 10_240),
                            ("llama4-maverick-400b-a17b", 320)):
        full = configs.get_config(arch)
        assert moe._capacity(4 * 8192, full) == prefill_c
        assert moe._capacity(4, full) == 8


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_matches_reference(arch):
    ref, cfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, cfg.d_model)).astype(np.float32)
    jp, tp = _both(_moe_params(cfg, 3, router_scale=4.0))
    _, ji, jgates = j_moe._route(jp, jnp.asarray(x), ref)
    want = j_moe._aux_loss(jgates, ji, cfg.moe.num_experts)
    got = moe._aux_loss(_t(jgates), _t(ji), cfg.moe.num_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    density, frac = moe._aux_stats(_t(jgates), _t(ji), cfg.moe.num_experts)
    jd, jf = j_moe._aux_stats(jgates, ji, cfg.moe.num_experts)
    np.testing.assert_allclose(density.numpy(), np.asarray(jd), atol=1e-7)
    np.testing.assert_allclose(frac.numpy(), np.asarray(jf), atol=1e-7)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [64.0, 0.25])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_local_matches_reference(arch, cf, dt):
    ref, cfg = _cfgs(arch, capacity_factor=cf, dtype=dt)
    rng = np.random.default_rng(4)
    B, S = 2, 40
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p = _moe_params(cfg, 4, router_scale=8.0)
    jx = jnp.asarray(x, getattr(jnp, dt))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, jaux = j_moe.moe_apply_local(jp, jx, ref)
    tp = {k: (_t(v) if k == "router" else _t(v).to(getattr(torch, dt)))
          for k, v in p.items()}
    got, aux = moe.moe_apply_local(tp, _t(np.asarray(jx.astype(
        jnp.float32))).to(getattr(torch, dt)), cfg)
    assert got.dtype == getattr(torch, dt) and aux.dtype == torch.float32
    tol = 1e-5 if dt == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the dropping case really drops (the routing is float32 either way)
    top_g, top_i, _ = moe._route(tp, _t(x.reshape(B * S, -1)), cfg)
    _, _, keep, _ = moe._dispatch(_t(x.reshape(B * S, -1)), top_g, top_i,
                                  cfg.moe.num_experts,
                                  moe._capacity(B * S, cfg))
    assert (float(keep.min()) == 0.0) == (cf < 1)


def test_moe_apply_raises_for_expert_parallelism():
    _, cfg = _cfgs("dbrx-132b")
    p = {k: _t(v) for k, v in _moe_params(cfg).items()}
    x = torch.zeros(1, 3, cfg.d_model)

    class Mesh:
        mesh = object()

    with pytest.raises(NotImplementedError, match="item 6"):
        moe.moe_apply(p, x, cfg, Mesh())
    out, _ = moe.moe_apply(p, x, cfg)
    assert out.shape == x.shape


# ---------------------------------------------------------------------------
# the model: serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def both_models(request):
    """(reference cfg, reference params, port model) at float32, reduced;
    the port's weights are the reference's."""
    ref, cfg = _cfgs(request.param)
    params = j_init(jax.random.key(0), ref)
    return ref, params, params_from_numpy(_np_tree(params), cfg,
                                          device="cpu")


def test_layers_run_in_the_reference_order(both_models):
    ref, _, model = both_models
    kinds = [layer.kind for layer in model.layers]
    if ref.moe.moe_every == 1:
        assert kinds == ["moe"] * ref.num_layers
    else:  # llama4: each group's dense layer first, its MoE layer last
        assert kinds == ["dense", "moe"] * (ref.num_layers // 2)
    for layer in model.layers:
        assert hasattr(layer, "moe") == (layer.kind == "moe")
        assert hasattr(layer, "mlp") == (layer.kind == "dense")


def test_serving_computes_no_aux_loss(both_models, monkeypatch):
    """Prefill and decode discard the aux loss, so they do not compute it:
    no ``_aux_loss`` call under a cache, and ``apply_stack`` returns None
    for it there; without a cache (training) each MoE layer adds its own."""
    from repro_torch.models import transformer

    ref, _, model = both_models
    calls = []
    real = moe._aux_loss
    monkeypatch.setattr(moe, "_aux_loss",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(5)
    B, S = 2, 12
    tokens = rng.integers(0, ref.vocab_size, (B, S)).astype(np.int32)
    cache = init_serve_cache(model.cfg, B, S + 2, dtype=torch.float32,
                             device="cpu")
    _, cache = prefill(model, {"tokens": _t(tokens), "cache": cache})
    pos = np.full((B,), S, np.int32)
    _, cache = decode_step(model, {"tokens": _t(tokens[:, :1]),
                                   "pos": _t(pos), "cache": cache})
    x = torch.randn(B, 1, ref.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, _, aux = transformer.apply_stack(
        model, x, positions=_t(pos + 1)[:, None], cache=cache)
    assert aux is None and calls == []
    _, _, aux = transformer.apply_stack(
        model, x, positions=torch.zeros((B, 1), dtype=torch.long))
    n_moe = sum(layer.kind == "moe" for layer in model.layers)
    assert len(calls) == n_moe and float(aux) > 0


def test_prefill_decode_float32_match_jax(both_models):
    """Logits and the nested KV cache (``moe`` stacked over the groups,
    ``dense`` over (groups, moe_every - 1)) within 1e-4 at float32, over
    prompts of 80 tokens and two decode steps."""
    ref, params, model = both_models
    rng = np.random.default_rng(3)
    B, S = 2, 80
    tokens = rng.integers(0, ref.vocab_size, (B, S)).astype(np.int32)
    max_len = S + 6
    jc = j_init_cache(ref, B, max_len, dtype=jnp.float32)
    tc = init_serve_cache(model.cfg, B, max_len, dtype=torch.float32,
                          device="cpu")
    assert sorted(tc) == sorted(jc)
    jl, jc = j_prefill(params, {"tokens": jnp.asarray(tokens), "cache": jc},
                       ref)
    tl, tc = prefill(model, {"tokens": _t(tokens), "cache": tc})
    steps = [(jl, tl, jc, tc)]
    for i in range(2):
        nxt = rng.integers(0, ref.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        _compare_step(*steps[-1])
        jl, jc = j_decode_step(params, {"tokens": jnp.asarray(nxt),
                                        "pos": jnp.asarray(pos),
                                        "cache": jc}, ref)
        tl, tc = decode_step(model, {"tokens": _t(nxt), "pos": _t(pos),
                                     "cache": tc})
        steps.append((jl, tl, jc, tc))
    _compare_step(*steps[-1])


def _compare_step(jl, tl, jc, tc):
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for kind in jc:
        for key in ("k", "v"):
            assert tuple(tc[kind][key].shape) == jc[kind][key].shape
            np.testing.assert_allclose(_np(tc[kind][key]),
                                       _np(jc[kind][key]), rtol=1e-4,
                                       atol=1e-4)
        for key in ("pos", "len"):
            assert np.array_equal(tc[kind][key].numpy(),
                                  np.asarray(jc[kind][key]))


def test_server_tokens_match_jax(both_models):
    """Greedy tokens of ``BatchedServer`` equal the reference server's at
    float32 (left-padded prompts, two batches, a dummy request)."""
    ref, params, model = both_models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, ref.vocab_size, n).astype(np.int32)
               for n in (30, 21, 26)]
    jsrv = j_serve.BatchedServer(ref, batch_size=2, max_len=40)
    pf, dc = jsrv.prefill, jsrv.decode
    jsrv.prefill = lambda batch: pf(params, batch)
    jsrv.decode = lambda batch: dc(params, batch)
    want = [r.out for r in jsrv.serve(
        [j_serve.Request(rid=i, tokens=p, max_new=4)
         for i, p in enumerate(prompts)])]
    srv = BatchedServer(model, batch_size=2, max_len=40)
    got = [r.out for r in srv.serve(
        [Request(rid=i, tokens=p, max_new=4)
         for i, p in enumerate(prompts)])]
    assert got == want
    assert srv.stats["tokens"] == 12 and srv.stats["finite"]


@pytest.mark.parametrize("arch", MOE)
def test_serving_build_keeps_the_router_float32(arch):
    """At the config's bfloat16: the experts, the shared expert and the
    attention in bfloat16, the router, norms, embed and head in float32,
    and a prefill's logits finite.  (Whole-model logits are not compared
    at bfloat16: a one-ulp difference in a hidden state can flip a
    near-tied routing choice in either package; ``moe_apply_local`` is
    compared at bfloat16 above, on routing with clear margins.)"""
    ref, cfg = _cfgs(arch, dtype="bfloat16")
    params = _np_tree(j_init(jax.random.key(1), ref))
    model = params_from_numpy(params, cfg, device="cpu")
    layer = model.stacked_layers("moe")[0]
    assert layer.moe["router"].dtype == torch.float32
    assert np.array_equal(layer.moe["router"].numpy(),
                          params["groups"]["moe"]["moe"]["router"][0])
    for name in ("wi", "wo") + (("shared_wi", "shared_wo")
                                if cfg.moe.shared_expert else ()):
        assert layer.moe[name].dtype == torch.bfloat16
    assert layer.attn["wq"].dtype == torch.bfloat16
    assert layer.ln1["scale"].dtype == torch.float32
    assert model.head.dtype == torch.float32
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, ref.vocab_size, (2, 20)).astype(np.int32)
    tl, _ = prefill(model, {"tokens": _t(tokens),
                            "cache": init_serve_cache(cfg, 2, 24,
                                                      device="cpu")})
    assert bool(torch.isfinite(tl[..., :ref.vocab_size]).all())


@pytest.mark.parametrize("arch", MOE)
def test_init_draws_expert_stacks_by_the_laws(arch):
    """Random weights by the reference's laws, an expert stack drawn one
    expert at a time (fan-in d either way), on the card unless asked."""
    _, cfg = _cfgs(arch, dtype="bfloat16")
    model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = model.stacked_layers("moe")[0]
    wi = layer.moe["wi"]
    assert wi.dtype == torch.bfloat16
    assert torch.equal(wi, again.stacked_layers("moe")[0].moe["wi"])
    assert not torch.equal(wi[0], wi[1])
    for e in range(cfg.moe.num_experts):
        assert abs(float(wi[e].float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    router = layer.moe["router"]
    assert router.dtype == torch.float32
    assert abs(float(router.std()) * cfg.d_model ** 0.5 / 0.1 - 1) < 0.1
    n = sum(p.numel() for p in model.parameters())
    extra = ((cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
             * (1 if cfg.tie_embeddings else 2))
    if cfg.norm == "layernorm":
        extra += (2 * cfg.num_layers + 1) * cfg.d_model
    assert n == cfg.param_count() + extra
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_model_params(cfg)


def test_serve_cli_runs_reduced_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "dbrx-132b", "--reduced", "--device", "cpu",
        "--requests", "3", "--prompt-len", "12", "--max-new", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert out.count("  req ") == 3


# ---------------------------------------------------------------------------
# the model: training forward, trees across the packages
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs[0, :3] = -1
    return {"tokens": toks, "labels": labs}


@pytest.mark.parametrize("arch", MOE)
def test_forward_train_matches_value_and_grad(arch):
    """loss, ce and aux within 1e-5 of the reference's, and the gradients
    within 1e-4 of each leaf's largest (``jax.value_and_grad``)."""
    from repro_torch.models.model import _stacked_to_numpy

    ref, cfg = _cfgs(arch)
    params = j_init(jax.random.key(0), ref)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.value_and_grad(
        lambda p: j_forward_train(p, jb, ref), has_aux=True)(params)
    model = params_from_numpy(_np_tree(params), cfg, device="cpu",
                              trainable=True)
    loss, m = forward_train(model, batch)
    loss.backward()
    assert float(m["aux"].detach()) > 0
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7)
    grads = _stacked_to_numpy(model, [p.grad for p in flat_leaves(model)[0]])
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(_np_tree(jg))):
        assert g.shape == w.shape
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol


@pytest.mark.parametrize("arch", MOE)
def test_params_and_opt_state_round_trip_the_reference_tree(arch):
    ref, cfg = _cfgs(arch)
    params = _np_tree(j_init(jax.random.key(2), ref))
    for trainable in (False, True):
        model = params_from_numpy(params, cfg, device="cpu",
                                  trainable=trainable)
        back = params_to_numpy(model)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(back), jax.tree.leaves(params)))
    for name, ts in train_leaves(model):
        lead = stack_dims(cfg, name)
        assert len(ts) == int(np.prod(lead))
    jstate = _np_tree(j_init_opt(params, JOptConfig()))
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.ndim else np.int32(5), jstate)
    st = opt_state_from_numpy(jstate, model, OptConfig())
    back = opt_state_to_numpy(model, st)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(jstate)))


def test_train_step_with_a_compressor_over_the_nested_stack():
    """One step of llama4 (dense layers stacked over (groups, 1)) with the
    int8 compressor: its state has the reference's leaf shapes, and the
    loss is finite."""
    from repro_torch.dist.compression import Int8Compressor
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import init_comp_state, make_train_step

    ref, cfg = _cfgs("llama4-maverick-400b-a17b")
    params = _np_tree(j_init(jax.random.key(3), ref))
    model = params_from_numpy(params, cfg, device="cpu", trainable=True)
    comp = init_comp_state(model)
    assert [tuple(c.shape) for c in comp] == [
        np.asarray(a).shape for a in jax.tree.leaves(params)]
    oc = OptConfig(warmup_steps=1, total_steps=2)
    step = make_train_step(cfg, oc, compressor=Int8Compressor())
    st = init_opt_state(flat_leaves(model)[0], oc)
    before = params_to_numpy(model)
    model, st, met, comp = step(model, st, _batch(cfg, seed=2), comp)
    assert np.isfinite(float(met["loss"])) and float(met["skipped"]) == 0
    after = params_to_numpy(model)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(before), jax.tree.leaves(after))]
    assert all(moved)
