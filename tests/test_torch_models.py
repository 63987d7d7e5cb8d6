"""The port's dense LM serving path against the JAX package's.

Same inputs, made from a seed with numpy, through the reference's
functions and the port's, for starcoder2-7b, glm4-9b and minitron-4b at
their reduced widths (``cfg.reduced()``: d_model 128, 4 heads, window 64
where the config has one):

* the configs field by field (the MoE family's too);
* ``apply_norm``, ``apply_mlp`` (GELU-tanh, relu2, swiglu) and
  ``apply_rope`` (``rope_fraction`` 1 and 0.5);
* ``prefill`` and ``decode_step`` from the same weights (the reference's
  ``init_model_params`` tree, through ``params_from_numpy``): at
  ``dtype="float32"`` logits and KV cache within rtol = atol = 1e-4, at the
  config's bfloat16 logits within 5e-2;
* ``BatchedServer`` and ``generate``: greedy tokens equal to the
  reference's at float32, with prompts longer than the reduced window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
import repro.launch.serve as j_serve
from repro.models import decode_step as j_decode_step
from repro.models import init_model_params as j_init
from repro.models import init_serve_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro.models.layers import apply_mlp as j_apply_mlp
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.layers import apply_rope as j_apply_rope
from repro.train.serve_step import generate as j_generate
from repro_torch import configs
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import (
    decode_step, init_model_params, init_serve_cache, params_from_numpy,
    prefill)
from repro_torch.models.layers import apply_mlp, apply_norm, apply_rope
from repro_torch.train.serve_step import generate

ARCHS = ["starcoder2-7b", "glm4-9b", "minitron-4b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS + ["mistral-large-123b", "dbrx-132b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-medium"])
def test_configs_match_reference(arch):
    ours, ref = configs.get_config(arch), j_configs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for c, r in ((ours, ref), (ours.reduced(), ref.reduced())):
        assert (c.vocab_padded, c.q_per_kv, c.param_count()) == \
            (r.vocab_padded, r.q_per_kv, r.param_count())
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in j_configs.LM_SHAPES]


def test_other_families_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="queue 1"):
        configs.get_config("paligemma-3b")
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    vlm = j_configs.get_config("paligemma-3b")
    cfg = configs.get_config("glm4-9b").with_overrides(family="vlm")
    with pytest.raises(NotImplementedError, match="item 9: other LM families"):
        init_serve_cache(cfg, 1, 8, device="cpu")
    assert vlm.family == "vlm"


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_norm_matches_jax(norm, dt):
    cfg = configs.get_config("starcoder2-7b").reduced().with_overrides(
        norm=norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)) * 3 + 1
    p = {"scale": rng.normal(size=cfg.d_model).astype(np.float32),
         "bias": rng.normal(size=cfg.d_model).astype(np.float32)}
    want = j_apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x, getattr(jnp, dt)), cfg)
    got = apply_norm({k: _t(v) for k, v in p.items()},
                     _t(np.asarray(jnp.asarray(x, getattr(jnp, dt))
                                   .astype(jnp.float32))).to(
                         getattr(torch, dt)), cfg)
    assert got.dtype == getattr(torch, dt)
    tol = 1e-5 if dt == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["gelu", "relu2", "swiglu"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_mlp_matches_jax(act, dt):
    cfg = configs.get_config("minitron-4b").reduced().with_overrides(
        mlp_activation=act)
    rng = np.random.default_rng(1)
    f = 2 * cfg.d_ff if act == "swiglu" else cfg.d_ff
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    p = {"wi": (rng.normal(size=(cfg.d_model, f)) * 0.1).astype(np.float32),
         "wo": (rng.normal(size=(cfg.d_ff, cfg.d_model)) * 0.1)
         .astype(np.float32)}
    jx = jnp.asarray(x, getattr(jnp, dt))
    want = j_apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, cfg)
    got = apply_mlp({k: _t(v) for k, v in p.items()},
                    _t(np.asarray(jx.astype(jnp.float32))).to(
                        getattr(torch, dt)), cfg)
    tol = 1e-5 if dt == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(fraction, dt):
    cfg = configs.get_config("glm4-9b").reduced().with_overrides(
        rope_fraction=fraction)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, cfg.num_heads, cfg.head_dim))
    pos = np.stack([np.arange(6), np.arange(100, 106)]).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dt))
    want = j_apply_rope(jx, jnp.asarray(pos), cfg)
    got = apply_rope(_t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dt)), _t(pos), cfg)
    tol = 2e-5 if dt == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the unrotated part passes through unchanged
    rot = int(cfg.head_dim * fraction)
    assert np.array_equal(_np(got)[..., rot:],
                          _np(jx.astype(jnp.float32))[..., rot:])


@pytest.fixture(scope="module", params=ARCHS)
def both_models(request):
    """(reference cfg, reference params, port model) at float32, reduced;
    the port's weights are the reference's."""
    ref = j_configs.get_config(request.param).reduced().with_overrides(
        dtype="float32")
    params = j_init(jax.random.key(0), ref)
    tree = jax.tree.map(np.asarray, params)
    cfg = configs.get_config(request.param).reduced().with_overrides(
        dtype="float32")
    return ref, params, params_from_numpy(tree, cfg, device="cpu")


def _run_both(ref, params, model, tokens, n_decode, cache_dtype):
    """Prefill ``tokens`` then decode ``n_decode`` fixed tokens through both
    packages, yielding the logits and caches after each step (the port's
    cache is updated in place: compare before the next step)."""
    B, S = tokens.shape
    max_len = S + n_decode + 4
    jc = j_init_cache(ref, B, max_len, dtype=getattr(jnp, cache_dtype))
    tc = init_serve_cache(model.cfg, B, max_len,
                          dtype=getattr(torch, cache_dtype), device="cpu")
    jl, jc = j_prefill(params, {"tokens": jnp.asarray(tokens), "cache": jc},
                       ref)
    tl, tc = prefill(model, {"tokens": _t(tokens), "cache": tc})
    yield jl, tl, jc, tc
    rng = np.random.default_rng(7)
    for i in range(n_decode):
        nxt = rng.integers(0, ref.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        jl, jc = j_decode_step(params, {"tokens": jnp.asarray(nxt),
                                        "pos": jnp.asarray(pos),
                                        "cache": jc}, ref)
        tl, tc = decode_step(model, {"tokens": _t(nxt), "pos": _t(pos),
                                     "cache": tc})
        yield jl, tl, jc, tc


def test_prefill_decode_float32_match_jax(both_models):
    """Logits and KV cache within 1e-4 at float32, over a prompt longer
    than the reduced window (64), so the window masks bite."""
    ref, params, model = both_models
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, ref.vocab_size, (2, 80)).astype(np.int32)
    for jl, tl, jc, tc in _run_both(ref, params, model, tokens, 2,
                                    "float32"):
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc["dense"][key]),
                                       _np(jc["dense"][key]), rtol=1e-4,
                                       atol=1e-4)
        for key in ("pos", "len"):
            assert np.array_equal(tc["dense"][key].numpy(),
                                  np.asarray(jc["dense"][key]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_bf16_match_jax(arch):
    """At the config's bfloat16, from the same float32 weights, logits
    within 5e-2 (the tolerance of ``tests/test_arch_smoke.py:103``)."""
    ref = j_configs.get_config(arch).reduced()
    params = j_init(jax.random.key(1), ref)
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              configs.get_config(arch).reduced(),
                              device="cpu")
    assert model.layers[0].attn["wq"].dtype == torch.bfloat16
    assert model.head.dtype == torch.float32
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, ref.vocab_size, (2, 70)).astype(np.int32)
    for jl, tl, _, _ in _run_both(ref, params, model, tokens, 2, "bfloat16"):
        v = ref.vocab_size
        np.testing.assert_allclose(_np(tl)[..., :v], _np(jl)[..., :v],
                                   rtol=5e-2, atol=5e-2)
        pad = tl[..., v:]
        assert pad.numel() == 0 or float(pad.max()) <= -1e29


def test_server_and_generate_tokens_match_jax(both_models):
    """Greedy tokens of the port's ``BatchedServer`` and ``generate`` equal
    the reference's at float32 (left-padded prompts of 65-90 tokens, two
    batches, the second padded with a dummy request)."""
    ref, params, model = both_models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, ref.vocab_size, n).astype(np.int32)
               for n in (90, 65, 77)]

    def reqs():
        return [Request(rid=i, tokens=p, max_new=5) for i, p in
                enumerate(prompts)]

    jsrv = j_serve.BatchedServer(ref, batch_size=2, max_len=100)
    pf, dc = jsrv.prefill, jsrv.decode
    jsrv.prefill = lambda batch: pf(params, batch)
    jsrv.decode = lambda batch: dc(params, batch)
    want = [r.out for r in jsrv.serve(
        [j_serve.Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new)
         for r in reqs()])]
    srv = BatchedServer(model, batch_size=2, max_len=100)
    got = [r.out for r in srv.serve(reqs())]
    assert got == want
    assert srv.stats["tokens"] == 15 and srv.stats["finite"]

    toks = np.stack([prompts[0][:70], prompts[1][:65].tolist() + [1] * 5])
    want = np.asarray(j_generate(params, jnp.asarray(toks), ref,
                                 max_new_tokens=4))
    got = generate(model, _t(toks), max_new_tokens=4)
    assert np.array_equal(got.numpy(), want)


def test_temperature_sampling_follows_its_generator():
    from repro_torch.train.serve_step import sample

    cfg = configs.get_config("minitron-4b").reduced()
    model = init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    draws = [generate(model, toks, max_new_tokens=4, temperature=1.5,
                      generator=torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert int(draws[0].max()) < cfg.vocab_size
    logits = torch.full((1, 1, 8), -1e30)
    logits[0, 0, 5] = 0.0
    assert int(sample(logits, 1.0, torch.Generator().manual_seed(0))) == 5
    assert int(sample(logits, 0.0, None)) == 5


def test_init_model_params_follows_the_init_laws():
    cfg = configs.get_config("starcoder2-7b").reduced()
    g = torch.Generator().manual_seed(0)
    model = init_model_params(cfg, g, device="cpu")
    again = init_model_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    wq = model.layers[0].attn["wq"]
    assert wq.dtype == torch.bfloat16 and model.embed.dtype == torch.float32
    assert torch.equal(wq, again.layers[0].attn["wq"])
    # fan-in scaled normal, embed 0.02, norms ones/zeros
    assert abs(float(wq.float().std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(model.embed.std()) / 0.02 - 1) < 0.05
    assert torch.equal(model.layers[1].ln1["scale"],
                       torch.ones(cfg.d_model))
    assert torch.equal(model.ln_f["bias"], torch.zeros(cfg.d_model))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.prod(s) for s in _shapes(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            init_model_params(cfg)


def _shapes(cfg):
    from repro_torch.models import model_schema
    from repro_torch.models.layers import ParamDef

    def walk(node):
        if isinstance(node, ParamDef):
            yield node.shape
        else:
            for v in node.values():
                yield from walk(v)

    return list(walk(model_schema(cfg)))


def test_apply_attention_raises_for_paths_not_ported():
    from repro_torch.models.attention import apply_attention, attn_schema
    from repro_torch.models.layers import init_leaf

    cfg = configs.get_config("glm4-9b").reduced()
    g = torch.Generator().manual_seed(0)
    p = {n: init_leaf(d, g, "cpu") for n, d in attn_schema(cfg).items()}
    x = torch.zeros(1, 3, cfg.d_model)
    pos = torch.arange(3)[None]
    cache = {n: t[0] for n, t in
             init_serve_cache(cfg, 1, 8, device="cpu")["dense"].items()}
    capped = cfg.with_overrides(attn_logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="item 9"):
        apply_attention(p, x, capped, positions=pos, layer_cache=cache)
    # without a cache (training, item 10, ported): the reference's output
    from repro.models.attention import apply_attention as j_apply_attention
    xr = torch.randn(2, 5, cfg.d_model, generator=g)
    pr = torch.arange(5)[None].expand(2, 5)
    got, none = apply_attention(p, xr, cfg, positions=pr, layer_cache=None,
                                window=cfg.sliding_window or None)
    want, _ = j_apply_attention(
        {n: jnp.asarray(t.numpy()) for n, t in p.items()},
        jnp.asarray(xr.numpy()), cfg, positions=jnp.asarray(pr.numpy()),
        window=cfg.sliding_window or None, layer_cache=None)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    cache["len"][0] = 6  # 6 + 3 tokens > 8 slots
    with pytest.raises(ValueError, match="overflows"):
        apply_attention(p, x, cfg, positions=pos, layer_cache=cache)
    # the cache helpers default to the card, as the entry points do
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.transformer import init_cache
    if not torch.cuda.is_available():
        for make in (lambda: init_kv_cache(cfg, 1, 8, 1),
                     lambda: init_cache(cfg, 1, 8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
