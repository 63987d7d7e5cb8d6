"""``chip_smoke.py``'s GoFS phases rehearsed on the CPU at TR_TINY.

On the card the smoke drives phase 6 (a GoFS deployment, the Gopher
session), 6c (two cluster worker processes) and 6d (mesh ranks) at
TR_SMALL.  Here the same functions run at TR_TINY with ``device="cpu"``,
where every check of the plain versions' results stays live and only the
launch counts are skipped, so that a fault in their control flow shows
before a card run, the depth cuts included: the session's streamed
sparse run over the first time pack held bitwise against the auto plan's
first instances, each worker's SSSP rerun in the kernel modes its auto
plans did not launch (both, on the CPU) held bitwise against its first
SSSP's first instances, and the mesh's in-memory runs and runs from the
store over the first time pack held against phases 5 and 5b's first
instances.
"""
import importlib.util
import json
import pathlib

import pytest
import torch

from repro_torch.configs.goffish_tr import TR_TINY

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield mod
    torch.set_num_threads(n)


def test_gofs_session_cluster_and_mesh_phases_on_the_cpu(smoke, monkeypatch):
    # TR_TINY has 6 instances: spans of 2 let the killed run die in its
    # second span as TR_SMALL's spans of 12 do
    monkeypatch.setattr(smoke, "RESUME_CHUNK", 2)
    log = []
    keep = smoke.main_path(TR_TINY, "cpu", log=log.append)
    smoke.query_phase(keep, "cpu", log=log.append)
    recs = smoke.gofs_path(TR_TINY, keep, "cpu", log=log.append)
    pack = TR_TINY.instances_per_slice
    assert recs["cut"] == {"host_ibsp_instances": pack,
                           "sparse_load_instances": pack,
                           "session_delta_route_instances": pack,
                           "cluster_other_mode_instances": pack}
    delta = recs["session"]["sssp_delta_fused"]
    assert delta["instances"] == pack
    assert delta["staged_bytes"] > 0
    cluster = recs["cluster"]
    assert cluster["rerun_modes"] == [["spmv", "fused"]] * 2
    assert cluster["rerun_instances"] == [pack] * 2
    assert cluster["snapshots_after_kill"] == [smoke.RESUME_CHUNK]
    mesh = recs["mesh"]
    assert mesh["cut"] == {"in_memory_instances": pack,
                           "model_data_store_instances": pack}
    # (a) streams every instance, across the time-pack boundaries
    bg = keep["bg"]
    whole = (keep["in_memory"]["lat"].shape[0] * bg.n_parts
             * (bg.t_max + bg.tb_max) * bg.block_size ** 2 * 4)
    assert mesh["stream_staged_bytes"]["nccl"][0]["sssp"] == whole
    assert mesh["control_failed"]


def test_flash_backward_sweep_on_the_cpu(smoke, monkeypatch):
    """The smoke's backward sweep (``bwd_sweep``) at tiny sizes on the CPU,
    one case a route and the wrong controls on the windowed case, where the
    wrappers run their plain versions; and the smoke's own cases cover the
    backward's three routes, the training layer's shape on the wgmma one."""
    from repro_torch.kernels.flash_attention.bwd import ROUTES

    cases = list(smoke.BWD_CASES)
    assert {smoke.bwd_route(c[-1], c[5]) for c in cases} == set(ROUTES)
    assert smoke.bwd_route(cases[0][-1], cases[0][5]) == \
        smoke.TRAIN_BWD_ROUTE == "bf16_wgmma"
    # without the mask, on every route, at Sq = Skv and Sq != Skv
    no_mask = [c for c in cases if not c[6]]
    assert {smoke.bwd_route(c[-1], c[5]) for c in no_mask} == set(ROUTES)
    assert {c[1:3] for c in no_mask} >= {(1500, 1500), (448, 1500)}
    monkeypatch.setattr(smoke, "BWD_CASES", [
        (1, 40, 40, 4, 2, 64, True, 0, "bfloat16"),
        (1, 70, 70, 9, 1, 128, True, 16, "bfloat16"),
        (2, 33, 33, 4, 4, 32, True, 0, "bfloat16"),
        (1, 30, 30, 4, 1, 16, True, 8, "float32"),
        (1, 20, 150, 4, 4, 64, False, 0, "bfloat16"),
    ])
    monkeypatch.setattr(smoke, "BWD_CONTROL_CASE", 1)
    log = []
    sweep = smoke.bwd_sweep(torch.Generator().manual_seed(3), "cpu",
                            log=log.append)
    assert [r["route"] for r in sweep] == [
        "bf16_wgmma", "bf16_wgmma", "bf16_mma_sync", "f32", "bf16_wgmma"]
    assert all(r["repeat_bitwise"] and r["limit_used"] <= 1.0
               for r in sweep)
    assert min(sweep[1]["controls_limit_used"].values()) > 1.0
    assert len(log) == 5


def test_moe_serve_phase_on_the_cpu(smoke, monkeypatch):
    """The smoke's MoE phase (``moe_serve``) at the reduced configs, llama4
    with its shared expert, on the CPU: the serve and its repeat, the drop
    shares, teacher forcing on the no-drop copy, the layer check against
    the token loop at both capacities and its two wrong controls, the
    attention kernels at the serve's layer-0 shapes with their controls
    (on the CPU the wrappers run their plain versions), the profile
    windows; only the launch counts are skipped.  The card's cuts keep full width."""
    import dataclasses

    from repro_torch.configs import get_config

    cut = smoke.moe_cut_configs()
    assert [(c.name, c.num_layers) for c in cut] == list(smoke.MOE_CUTS)
    for c in cut:
        full = get_config(c.name)
        assert dataclasses.replace(c, num_layers=full.num_layers) == full
    assert smoke.MOE_CHECK_T // smoke.MOE_DROP_DISTINCT > 8
    for name, value in (("SERVE_PROMPT", 24), ("SERVE_NEW", 3),
                        ("MOE_PARITY_S", 20), ("MOE_CHECK_T", 64),
                        ("MOE_DROP_DISTINCT", 8)):
        monkeypatch.setattr(smoke, name, value)
    cfgs = []
    for arch, _ in smoke.MOE_CUTS:
        full = get_config(arch)
        c = full.reduced()
        cfgs.append(c.with_overrides(moe=dataclasses.replace(
            c.moe, shared_expert=full.moe.shared_expert)))
    log = []
    recs = smoke.moe_serve(cfgs, "cpu", device="cpu", log=log.append)
    assert list(recs) == [c.name for c in cfgs]
    for c in cfgs:
        rec = recs[c.name]
        assert rec["tokens"] == smoke.SERVE_REQUESTS * 3
        assert rec["params"] == smoke.schema_params(c)
        n_moe = c.num_layers // c.moe.moe_every
        assert len(rec["prefill_dropped_share_by_moe_layer"]) == n_moe
        assert rec["teacher_forcing"]["max_abs_err"] <= smoke.PARITY_TOL
        check = rec["layer_check"]
        assert check["dropping"]["dropped"] > 0
        for run in ("nominal", "dropping"):
            assert check[run]["limit_used"] <= 1.0
            assert min(check[run]["controls_limit_used"].values()) > 1.0
    assert recs["llama4-maverick-400b-a17b"]["kinds"] == ["dense", "moe"] * 2
    for c in cfgs:
        att = recs[c.name]["attention_check"]
        assert [att[k]["group"] for k in att] == [
            c.num_heads // c.num_kv_heads] * 2
        for k in ("flash_attention_cuda", "decode_attention_cuda"):
            assert att[k]["limit_used"] <= 1.0
            assert len(att[k]["controls_limit_used"]) == (
                2 if k == "flash_attention_cuda" else 3)
            assert min(att[k]["controls_limit_used"].values()) > 1.0
    # serve, the attention check, two profile windows, teacher forcing,
    # layer check
    assert sum(ln.startswith("phase moe_") for ln in log) == 6 * len(cfgs)


def test_moe_train_phase_on_the_cpu(smoke, monkeypatch):
    """The smoke's MoE training phase (``moe_train_path``) at the reduced
    configs cut as MOE_TRAIN_CUTS cuts depth, llama4 with its shared
    expert, 32-token sequences, on the CPU: the cut record, every step
    finite with aux > 0 and none skipped, the dispatches per micro-batch
    and their recompute, the attention wrappers called as the remat
    policy implies (on the CPU they run their plain versions and launch
    nothing), the attention checks at layer 0's training shapes and the
    MoE layer's gradient check with every control over its limit, and the
    remat op counts (``dots``: the experts' bmms and kernel 3 again, no
    mm; ``full``: mms too).  The card's runs keep full width."""
    import dataclasses

    from repro_torch.configs import get_config

    runs = smoke.moe_train_configs()
    assert [(c.name, c.num_layers, c.moe.num_experts, c.remat)
            for c, _ in runs] == [
        (r["arch"], r["layers"], r["experts"], r["remat"])
        for r in smoke.MOE_TRAIN_CUTS]
    for c, run in runs:
        full = get_config(c.name)
        assert dataclasses.replace(
            c, num_layers=full.num_layers, remat=full.remat,
            moe=dataclasses.replace(c.moe, num_experts=full.moe.num_experts)
        ) == full
        assert smoke.moe_train_launches(c, run) == (
            2 * c.num_layers * run["accum_steps"] * run["steps"],
            c.num_layers * run["accum_steps"] * run["steps"])
    # dbrx at C = 5,120, llama4 at C = 640 (tokens of one micro-batch)
    from repro_torch.models import moe

    assert [moe._capacity(r["global_batch"] // r["accum_steps"] * 4096, c)
            for c, r in runs] == [5120, 640]
    for name, value in (("MOE_CHECK_T", 64), ("MOE_DROP_DISTINCT", 8),
                        ("MOE_REMAT_S", 48)):
        monkeypatch.setattr(smoke, name, value)
    small = []
    for c, run in runs:
        full = get_config(c.name)
        r = full.reduced()
        small.append((r.with_overrides(
            num_layers=c.num_layers, remat=c.remat,
            moe=dataclasses.replace(
                r.moe, shared_expert=full.moe.shared_expert)), run))
    log = []
    recs = smoke.moe_train_path(small, "cpu", device="cpu", log=log.append,
                                seq_len=32)
    cuts = json.loads(log[0][len("moe_train cuts: "):])
    assert list(cuts) == [c.name for c, _ in small]
    assert cuts["dbrx-132b"]["experts"] == [16, 4]
    assert cuts["dbrx-132b"]["state_dtype"] == "bfloat16"
    for c, run in small:
        rec = recs[c.name]
        assert rec["params"] == smoke.schema_params(c)
        assert len(rec["steps"]) == run["steps"]
        assert all(h["aux"] > 0 and h["skipped"] == 0 for h in rec["steps"])
        n_fwd, n_bwd = smoke.moe_train_launches(c, run)
        assert rec["wrapper_calls"] == {"flash_attention_cuda": n_fwd,
                                        "flash_attention_bwd_cuda": n_bwd}
        n_moe = rec["kinds"].count("moe")
        assert len(rec["drop_share_by_dispatch"]) == (
            2 * n_moe * run["accum_steps"] * run["steps"])
        for k, att in rec["attention_check"].items():
            assert att["group"] == c.num_heads // c.num_kv_heads
            assert att["limit_used"] <= 1.0
            assert len(att["controls_limit_used"]) == 2
            assert min(att["controls_limit_used"].values()) > 1.0
        for case in ("nominal", "dropping"):
            g = rec["grad_check"][case]
            assert max(g["limit_used"].values()) <= 1.0
            assert min(g["controls_limit_used"].values()) > 1.0
            assert ("router" in g["limit_used"]) == (c.moe.top_k > 1)
        assert rec["grad_check"]["dropping"]["dropped"] > 0
        ops = rec["remat_ops"]["recomputed"]
        assert ops["expert_bmm"] == 2 * n_moe
        assert ops["flash"] == c.num_layers
        assert (ops["mm"] == 0) == (c.remat == "dots")
    # per model: the run, its profile, the attention check, the gradient
    # check, the op count
    assert sum(ln.startswith("phase moe_train_") for ln in log) == 5 * len(
        small)


def test_audio_serve_phase_on_the_cpu(smoke, monkeypatch):
    """The smoke's audio phase (``audio_serve``, phase 8c) at whisper's
    reduced config on the CPU, with 150 frames so that the last key block
    is ragged as the card's 1,500 are: the serve and its repeat (two
    batches, the encoder timed once each), the five layer-0 calls against
    the plain versions with their controls (a causal encoder, the ragged
    block dropped, the causal edge, the newest key lost, the wrong KV
    heads: MHA in cross-attention, G = 2 in the reduced self-attention),
    the cross decode again with its last frame planted on the queries
    and that frame or its ragged block lost, teacher forcing, the profile
    windows; only the
    launch counts and the timing (``audio_timing``) are left to the card,
    whose run keeps whisper-medium's full width and depth."""
    from repro_torch.configs import get_config

    full = get_config(smoke.AUDIO_ARCH)
    assert (full.encoder_layers, full.num_layers, full.encoder_seq_len) == (
        24, 24, 1500)
    assert (smoke.AUDIO_REQUESTS, smoke.AUDIO_BATCH, smoke.AUDIO_PROMPT,
            smoke.AUDIO_NEW) == (8, 8, 224, 64)
    assert smoke.AUDIO_PROMPT + smoke.AUDIO_NEW <= 448  # n_text_ctx
    for name, value in (("AUDIO_REQUESTS", 3), ("AUDIO_BATCH", 2),
                        ("AUDIO_PROMPT", 10), ("AUDIO_NEW", 3)):
        monkeypatch.setattr(smoke, name, value)
    cfg = full.reduced().with_overrides(encoder_seq_len=150)
    log = []
    rec = smoke.audio_serve(cfg, "cpu", device="cpu", log=log.append)
    assert rec["tokens"] == 3 * 3 and rec["finite"]
    assert rec["encoder_s"] > 0 and len(rec["profile"]) == 2
    assert rec["repeat"]["identical_tokens"]
    assert rec["teacher_forcing"]["max_abs_err"] <= smoke.PARITY_TOL
    calls = rec["calls"]
    assert list(calls) == list(smoke.AUDIO_CALLS)
    B, H, K, d = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert calls["encoder"]["q"] == calls["encoder"]["kv"][:2] + [H, d] == [
        B, 150, H, d]
    assert calls["cross prefill"]["q"] == [B, 10, H, d]
    assert calls["cross prefill"]["kv"] == [B, 150, H, d]
    assert calls["cross decode"]["lengths"] == [150] * B
    assert calls["self decode"]["lengths"] == [11] * B
    assert [calls[c]["group"] for c in smoke.AUDIO_CALLS] == [
        H // K, H // K, 1, H // K, 1]
    planted = calls["cross decode"]["planted"]
    assert [len(c["controls_limit_used"]) for c in calls.values()] + [
        len(planted["controls_limit_used"])] == [2, 2, 2, 2, 1, 3]
    for c in list(calls.values()) + [planted]:
        assert c["limit_used"] <= 1.0
        assert min(c["controls_limit_used"].values()) > 1.0
    # serve, the attention check, teacher forcing, two profile windows
    assert sum(ln.startswith("phase audio_") for ln in log) == 5


def test_audio_train_phase_on_the_cpu(smoke, monkeypatch):
    """The smoke's audio training phase (``audio_train_path``, phase 11c)
    at whisper's reduced config on the CPU, with 150 frames so that the
    last key block is ragged as the card's 1,500 are, 2 clips of 10
    tokens a step and the config's full remat: the cuts line, every step
    finite and none skipped, the attention wrappers called as a step
    implies (on the CPU they run their plain versions and launch nothing),
    the profile window, the checkpoint restored bit for bit, and the
    layer-0 checks of the encoder's and the cross-attention's no-mask
    calls with every control over its limit (the causal mask, Skv taken
    as Sq, the ragged block dropped with the last frame planted); the
    launch counts by route and the timing (``audio_train_timing``) are
    left to the card, whose run keeps whisper-medium's full width and
    depth."""
    from repro_torch.configs import get_config

    full = get_config(smoke.AUDIO_ARCH)
    assert (full.encoder_layers, full.num_layers, full.d_model,
            full.num_heads, full.head_dim, full.remat) == (
        24, 24, 1024, 16, 64, "full")
    assert (smoke.AUDIO_TRAIN_CLIPS, smoke.AUDIO_TRAIN_TEXT,
            smoke.AUDIO_TRAIN_STEPS, smoke.AUDIO_TRAIN_CUTS) == (
        4, 448, 3, {})
    assert smoke.audio_train_launches(full) == (144, 72)
    for name, value in (("AUDIO_TRAIN_CLIPS", 2), ("AUDIO_TRAIN_TEXT", 10),
                        ("AUDIO_TRAIN_STEPS", 2)):
        monkeypatch.setattr(smoke, name, value)
    cfg = full.reduced().with_overrides(encoder_seq_len=150, remat="full")
    log = []
    out = smoke.audio_train_path(cfg, "cpu", device="cpu", log=log.append)
    assert log[0].startswith("audio_train cuts: {} ")
    rec = out["train"]
    assert rec["params"] == smoke.schema_leaves(cfg)
    assert len(rec["steps"]) == 2
    assert all(h["skipped"] == 0 for h in rec["steps"])
    n_fwd, n_bwd = smoke.audio_train_launches(cfg)
    assert rec["wrapper_calls"] == {"flash_attention_cuda": 2 * n_fwd,
                                    "flash_attention_bwd_cuda": 2 * n_bwd}
    assert rec["checkpoint"]["bitwise"]
    # the reduced encoder has G = 2 (whisper-medium's is MHA); the
    # cross-attention is MHA
    B, H, K, d = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {kind: [list(t.shape) for t in out["shapes"][kind][:2]]
              for kind in smoke.AUDIO_TRAIN_KINDS}
    assert shapes == {"encoder": [[B, 150, H, d], [B, 150, K, d]],
                      "cross": [[B, 10, H, d], [B, 150, H, d]]}
    check = rec["attention_check"]
    for kind, n_ctl in (("encoder", (1, 2)), ("cross", (2, 3))):
        for k, n in zip(("flash_attention_cuda", "flash_attention_bwd_cuda"),
                        n_ctl):
            c = check[kind][k]
            assert c["limit_used"] <= 1.0
            assert len(c["controls_limit_used"]) == n
            assert min(c["controls_limit_used"].values()) > 1.0
        assert check[kind]["flash_attention_bwd_cuda"][
            "planted_dq_control_limit_used"] > 1.0
    # the run, its profile, the checkpoint, the attention check
    assert sum(ln.startswith("phase audio_train") for ln in log) == 4
