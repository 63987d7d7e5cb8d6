"""The port's audio family (whisper-medium) against the JAX package's.

Same inputs, made from a seed with numpy, through the reference's functions
and the port's, at whisper-medium's reduced config (``cfg.reduced()``: 2
encoder and 4 decoder layers, d_model 128, 4 query heads over 2 KV heads in
self-attention, MHA in cross-attention, 32 frames).  The float32 cases'
weights are drawn from seed 0 through the port's ``init_model_params``
(:func:`seeded_params`), the same in every process: the reference's
``init_params`` folds each leaf's key with Python's ``hash`` of its path,
which is salted per process, so its weights would make each run of the
suite check another model.

* ``sinusoidal_positions`` and ``sinusoidal_at`` within 1e-6;
* the reference's own parameter tree (its ``init_model_params``) through
  ``params_from_numpy`` and back through ``params_to_numpy``, bit for bit
  and in the same structure;
* ``encode`` and ``cross_kv_all_layers`` within 1e-5 at float32, and the
  encoder non-causal (the last frame moves position 0's output);
* the cross-attention branch of ``apply_attention`` for a prompt and for
  one token, over bfloat16 cross K/V as the reference's ``prefill`` stores
  them;
* ``prefill`` and ``decode_step``: at float32 the logits, the
  self-attention cache and the bfloat16 cross K/V within rtol = atol =
  1e-4 (the reference rounds ``p`` to bfloat16 over the cross K/V; the
  port's plain versions round it as it does), at the config's bfloat16
  the logits within 5e-2 (``tests/test_torch_models.py``'s tolerances).
  The float32 run's cross K/V are rounded to bfloat16 from values that
  differ from the reference's by about 1e-6 (sums in another order), so
  a few entries round one bfloat16 step apart, which moves the later
  decoder layers' self-attention K/V past 1e-4: the step-by-step
  comparison rounds the reference's float32 cross K/V in the port's
  cache (its own are held before rounding within 1e-5 by
  ``test_encode_and_cross_kv_match_jax``), and the port's own prefill is
  held apart, its logits within 1e-4 and each cross entry that differs
  one bfloat16 step apart (or within the 1e-5 the float32 values may
  differ by) at a value that lies within 1e-5 of the midpoint of the
  two;
  A control must fail the 1e-4: the port's cross-attention dropping the
  last frame moves the prefill logits past it;
* ``BatchedServer`` and ``generate`` with ``frames``: the reference's
  greedy tokens at float32;
* the serving CLI at the reduced config on the CPU.

The audio family's training is held in ``tests/test_torch_audio_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
import repro.launch.serve as j_serve
from repro.dist.sharding import CPU_RUNTIME
from repro.models import decode_step as j_decode_step
from repro.models import encdec as j_encdec
from repro.models import init_model_params as j_init
from repro.models import init_serve_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro.models.attention import apply_attention as j_apply_attention
from repro.models.attention import make_cross_kv as j_make_cross_kv
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.train.serve_step import generate as j_generate
from repro_torch import configs
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import (
    decode_step, encdec, forward_train, init_model_params, init_serve_cache,
    model_schema, params_from_numpy, params_to_numpy, prefill)
from repro_torch.models.attention import apply_attention, make_cross_kv
from repro_torch.models.layers import ParamDef, sinusoidal_positions
from repro_torch.train.serve_step import generate

ARCH = "whisper-medium"


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


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def seeded_params(cfg, seed=0):
    """The reference's parameter tree (numpy) drawn from one explicit seed,
    through the port's ``init_model_params`` on a seeded CPU generator.
    The reference's own ``init_params`` folds each leaf's key with
    Python's ``hash`` of its path, which is salted per process, so its
    weights would change from one run of the suite to the next."""
    model = init_model_params(cfg, torch.Generator().manual_seed(seed),
                              device="cpu", trainable=True)
    return params_to_numpy(model)


@pytest.fixture(scope="module")
def both():
    """(reference cfg, reference params, port model) at float32, reduced;
    the same weights in both, drawn from seed 0 (:func:`seeded_params`)."""
    ref = j_configs.get_config(ARCH).reduced().with_overrides(
        dtype="float32")
    cfg = configs.get_config(ARCH).reduced().with_overrides(dtype="float32")
    tree = seeded_params(cfg)
    return ref, jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, cfg, device="cpu")


def _frames(ref, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, ref.encoder_seq_len, ref.d_model)).astype(
        np.float32)


def test_reduced_config_is_the_one_described():
    cfg = configs.get_config(ARCH).reduced()
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.encoder_seq_len) == (2, 4, 128, 4, 2, 32)
    full = configs.get_config(ARCH)
    assert (full.param_count(), full.vocab_padded) == (810_961_920, 51_968)


@pytest.mark.parametrize("n,d", [(32, 128), (448, 128), (1500, 64)])
def test_sinusoidal_positions_match_jax(n, d):
    _close(sinusoidal_positions(n, d), j_sinusoidal(n, d), 1e-6)


def test_sinusoidal_at_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 448, (3, 7)).astype(np.int32)
    pos[0, 0] = 0
    d = configs.get_config(ARCH).reduced().d_model
    got = encdec.sinusoidal_at(_t(pos), d)
    assert got.dtype == torch.float32 and got.shape == (3, 7, d)
    _close(got, j_encdec.sinusoidal_at(jnp.asarray(pos), d), 1e-6)
    # the table's rows at the same positions
    _close(got[1], sinusoidal_positions(448, d)[_t(pos[1]).long()], 1e-6)


def test_params_round_trip_is_exact(both):
    """The reference's own tree (``init_model_params``; its hash-salted
    values do not matter to an exact round trip) through
    ``params_from_numpy`` and back, bit for bit and in the same
    structure; the port's model holds every leaf of the schema."""
    ref, _, seeded = both
    want = jax.tree.map(np.asarray, j_init(jax.random.key(0), ref))
    model = params_from_numpy(want, seeded.cfg, device="cpu")
    got = params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    n = sum(p.numel() for p in model.parameters())

    def shapes(node):
        if isinstance(node, ParamDef):
            yield node.shape
        else:
            for v in node.values():
                yield from shapes(v)

    assert n == sum(np.prod(s) for s in shapes(model_schema(model.cfg)))
    assert len(model.enc_layers) == ref.encoder_layers
    assert [layer.cross for layer in model.layers] == [True] * ref.num_layers
    assert not any(layer.cross for layer in model.enc_layers)
    assert model.layers[0].xattn["wk"].shape == (ref.d_model,
                                                ref.num_heads * ref.head_dim)


def test_encode_and_cross_kv_match_jax(both):
    ref, params, model = both
    frames = _frames(ref, 2, 1)
    want = j_encdec.encode(params, jnp.asarray(frames), ref, CPU_RUNTIME)
    got = encdec.encode(model, _t(frames))
    assert got.shape == frames.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)
    jk, jv = j_encdec.cross_kv_all_layers(params, want, ref)
    tk, tv = encdec.cross_kv_all_layers(model, got)
    assert tuple(tk.shape) == (ref.num_layers, 2, ref.encoder_seq_len,
                               ref.num_heads, ref.head_dim)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)
    # written into a cache's bfloat16 pair, as prefill stores them
    out = tuple(torch.zeros(tk.shape, dtype=torch.bfloat16)
                for _ in range(2))
    assert encdec.cross_kv_all_layers(model, got, out=out) is out
    assert torch.equal(out[0], tk.bfloat16())
    assert torch.equal(out[1], tv.bfloat16())


def test_encoder_is_not_causal(both):
    """Changing the last frame moves position 0's encoder output (a causal
    encoder would leave it), and the port agrees with the reference on
    both inputs."""
    ref, params, model = both
    frames = _frames(ref, 1, 2)
    moved = frames.copy()  # a new last frame (LayerNorm drops a shift)
    moved[:, -1] = np.random.default_rng(3).normal(size=ref.d_model) * 3
    a = encdec.encode(model, _t(frames))
    b = encdec.encode(model, _t(moved))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    _close(b, j_encdec.encode(params, jnp.asarray(moved), ref, CPU_RUNTIME),
           1e-5)


@pytest.mark.parametrize("Sq", [5, 1])
def test_cross_attention_branch_matches_jax(both, Sq):
    """Prefill (the flash wrapper) and one-token decode (the decode
    wrapper) over bfloat16 cross K/V, against the reference's
    ``chunked_attention`` branch."""
    ref, params, model = both
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, ref.encoder_seq_len, ref.d_model)).astype(
        np.float32)
    x = rng.normal(size=(2, Sq, ref.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq) + 7, (2, Sq)).astype(np.int32)
    jp = jax.tree.map(lambda a: a[0], params["dec_groups"]["dense"]["xattn"])
    jkv = tuple(a.astype(jnp.bfloat16)
                for a in j_make_cross_kv(jp, jnp.asarray(enc), ref))
    want, none = j_apply_attention(jp, jnp.asarray(x), ref,
                                   positions=jnp.asarray(pos),
                                   cross_kv=jkv, rope=False)
    tp = model.layers[0].xattn
    tkv = tuple(t.bfloat16() for t in make_cross_kv(tp, _t(enc), model.cfg))
    assert tkv[0].shape == (2, ref.encoder_seq_len, ref.num_heads,
                            ref.head_dim)  # MHA: 4 heads, not 2
    for a, b in zip(tkv, jkv):
        assert np.array_equal(_np(a), _np(b))
    got, cache = apply_attention(tp, _t(x), model.cfg, positions=_t(pos),
                                 layer_cache=None, rope=False, cross_kv=tkv)
    assert none is None and cache is None
    _close(got, want, 1e-5)


def _run_both(ref, params, model, tokens, frames, n_decode, cache_dtype):
    """Prefill ``tokens`` with ``frames`` then decode ``n_decode`` fixed
    tokens through both packages, yielding the logits and caches after each
    step (the port's cache is updated in place: compare before the next
    step)."""
    B, S = tokens.shape
    max_len = S + n_decode + 4
    jc = j_init_cache(ref, B, max_len, dtype=getattr(jnp, cache_dtype))
    tc = init_serve_cache(model.cfg, B, max_len,
                          dtype=getattr(torch, cache_dtype), device="cpu")
    jl, jc = j_prefill(params, {"tokens": jnp.asarray(tokens), "cache": jc,
                                "frames": jnp.asarray(frames)}, ref)
    tl, tc = prefill(model, {"tokens": _t(tokens), "cache": tc,
                             "frames": _t(frames)})
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


def test_prefill_decode_float32_match_jax(both, monkeypatch):
    """Logits, the self-attention cache and the bfloat16 cross K/V within
    1e-4 at float32, over a prefill and three decode steps; the cross K/V
    rounded from the reference's float32 values (see the module's
    docstring), and the port's own prefill held apart."""
    ref, params, model = both
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, ref.vocab_size, (2, 9)).astype(np.int32)
    frames = _frames(ref, 2, 5)
    # the port's own prefill: logits, and the cross K/V one bf16 step apart
    # where float32 values that differ by sums' order straddle a midpoint
    (jl, tl, jc, tc), = _run_both(ref, params, model, tokens, frames, 0,
                                  "float32")
    _close(tl, jl, 1e-4)
    jf = j_encdec.cross_kv_all_layers(
        params, j_encdec.encode(params, jnp.asarray(frames), ref,
                                CPU_RUNTIME), ref)
    for got, want, f32 in zip(tc["cross"], jc["cross"], jf):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        g, w, f = _np(got), _np(want), np.asarray(f32)
        apart = g != w
        assert apart.mean() < 1e-3
        # one bf16 step (at most 2^-7 of the value) or, for tiny values,
        # the 1e-5 that the float32 values may differ by
        step = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) + 1e-5
        assert np.all(np.abs(g - w)[apart] <= step[apart])
        mid = (g + w)[apart] / 2  # the midpoint between the two roundings
        assert np.all(np.abs(f[apart] - mid) <= 1e-5)

    def reference_cross_kv(model_, enc_out, out):
        for o, a in zip(out, jf):
            o.copy_(_t(a))  # rounded to bfloat16 as the reference's astype
        return out

    monkeypatch.setattr(encdec, "cross_kv_all_layers", reference_cross_kv)
    for jl, tl, jc, tc in _run_both(ref, params, model, tokens, frames, 3,
                                    "float32"):
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        _close(tl, jl, 1e-4)
        for key in ("k", "v"):
            _close(tc["self"]["dense"][key], jc["self"]["dense"][key], 1e-4)
        for key in ("pos", "len"):
            assert np.array_equal(tc["self"]["dense"][key].numpy(),
                                  np.asarray(jc["self"]["dense"][key]))
        for got, want in zip(tc["cross"], jc["cross"]):
            assert np.array_equal(_np(got), _np(want))


def test_prefill_float32_control_dropping_the_last_frame_fails(
        both, monkeypatch):
    """The 1e-4 of :func:`test_prefill_decode_float32_match_jax` has teeth:
    a port whose cross-attention drops the last of the 32 frames (the
    prompt's flash call over the cross K/V sees 31 keys) moves the prefill
    logits past it, while the same comparison passes without the fault."""
    from repro_torch.models import attention

    ref, params, model = both
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, ref.vocab_size, (2, 9)).astype(np.int32)
    frames = _frames(ref, 2, 5)

    def used():
        (jl, tl, _, _), = _run_both(ref, params, model, tokens, frames, 0,
                                    "float32")
        w = _np(jl)
        return float((np.abs(_np(tl) - w) / (1e-4 + 1e-4 * np.abs(w))).max())

    assert used() <= 1.0
    flash = attention.flash_attention_cuda

    def drop_last_frame(q, k, v, **kw):
        if not kw.get("causal", True) and q.shape[1] != k.shape[1]:
            k, v = k[:, :-1], v[:, :-1]  # the cross call: 31 of 32 frames
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_cuda", drop_last_frame)
    assert used() > 1.0


def test_prefill_decode_bf16_match_jax():
    """At the config's bfloat16, from the same float32 weights, logits
    within 5e-2 (``tests/test_torch_models.py``'s bf16 tolerance)."""
    ref = j_configs.get_config(ARCH).reduced()
    params = j_init(jax.random.key(1), ref)
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              configs.get_config(ARCH).reduced(),
                              device="cpu")
    assert model.layers[0].xattn["wq"].dtype == torch.bfloat16
    assert model.enc_layers[0].attn["wq"].dtype == torch.bfloat16
    assert model.head.dtype == torch.float32
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, ref.vocab_size, (2, 6)).astype(np.int32)
    v = ref.vocab_size
    for jl, tl, _, tc in _run_both(ref, params, model, tokens,
                                   _frames(ref, 2, 9), 2, "bfloat16"):
        _close(tl[..., :v], np.asarray(jl, np.float32)[..., :v], 5e-2)
        pad = tl[..., v:]
        assert pad.numel() == 0 or float(pad.max()) <= -1e29


def test_server_and_generate_tokens_match_jax(both):
    """Greedy tokens of the port's ``BatchedServer`` (frames in
    ``extra_inputs``) and ``generate`` (``extra_inputs=``) equal the
    reference's at float32: left-padded prompts of 4-9 tokens, two
    batches, the second padded with a dummy request."""
    ref, params, model = both
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, ref.vocab_size, n).astype(np.int32)
               for n in (9, 4, 6)]
    frames = _frames(ref, 2, 10)

    def reqs():
        return [Request(rid=i, tokens=p, max_new=5) for i, p in
                enumerate(prompts)]

    jsrv = j_serve.BatchedServer(ref, batch_size=2, max_len=20)
    pf, dc = jsrv.prefill, jsrv.decode
    jsrv.prefill = lambda batch: pf(params, batch)
    jsrv.decode = lambda batch: dc(params, batch)
    jsrv.extra_inputs["frames"] = jnp.asarray(frames)
    want = [r.out for r in jsrv.serve(
        [j_serve.Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new)
         for r in reqs()])]
    srv = BatchedServer(model, batch_size=2, max_len=20)
    srv.extra_inputs["frames"] = _t(frames)
    got = [r.out for r in srv.serve(reqs())]
    assert got == want
    assert srv.stats["tokens"] == 15 and srv.stats["finite"]

    toks = np.stack([prompts[0][:6], prompts[2]])
    want = np.asarray(j_generate(params, jnp.asarray(toks), ref,
                                 max_new_tokens=4,
                                 extra_inputs={"frames": jnp.asarray(frames)}))
    got = generate(model, _t(toks), max_new_tokens=4,
                   extra_inputs={"frames": _t(frames)})
    assert np.array_equal(got.numpy(), want)


def test_serve_cache_and_non_causal_attention_guards():
    cfg = configs.get_config(ARCH).reduced()
    cache = init_serve_cache(cfg, 3, 12, device="cpu")
    assert set(cache) == {"self", "cross"}
    assert cache["self"]["dense"]["k"].shape == (cfg.num_layers, 3, 12,
                                                 cfg.num_kv_heads,
                                                 cfg.head_dim)
    for t in cache["cross"]:
        assert t.dtype == torch.bfloat16
        assert t.shape == (cfg.num_layers, 3, cfg.encoder_seq_len,
                           cfg.num_heads, cfg.head_dim)
    if not torch.cuda.is_available():  # the cache defaults to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_serve_cache(cfg, 1, 4)
    # a non-causal call takes no cache; on a trainable model it has a
    # gradient (the flash backward's plain version on the CPU)
    model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              trainable=True)
    layer = model.enc_layers[0]
    x = torch.randn(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    y, none = apply_attention(layer.attn, x, cfg, positions=pos,
                              layer_cache=None, rope=False, causal=False)
    assert none is None and y.shape == x.shape and y.grad_fn is not None
    y.sum().backward()
    assert layer.attn["wk"].grad is not None
    assert float(layer.attn["wk"].grad.abs().max()) > 0
    one = {n: t[0] for n, t in cache["self"]["dense"].items()}
    with pytest.raises(ValueError, match="non-causal"):
        apply_attention(model.layers[0].attn, x.bfloat16(), cfg,
                        positions=pos, layer_cache=one, rope=False,
                        causal=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_configs.get_config(ARCH).reduced())


def test_serve_cli_runs_reduced_on_the_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch whisper-medium --reduced
    --device cpu``: frames drawn from the seed, every request answered."""
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--requests", "3", "--prompt-len", "6", "--max-new", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert out.count("  req ") == 3
