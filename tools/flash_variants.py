#!/usr/bin/env python3
"""Time design variants of the wgmma flash kernel on one card.

    python3 tools/flash_variants.py

Each variant is the committed ``src/repro_torch`` with one textual edit of
``kernels/csrc/flash_attention.cu``, copied to ``build/flash_variants/``
(git-ignored), built there and timed in a process of its own (two builds
of the kernel library in one process interpose their symbols):

* ``committed``: the source as it is;
* ``two_stages``: a ring of two K/V stages instead of three;
* ``mask_all``: the per-element mask evaluated on every key block, not
  only on the edge blocks of a query block's range;
* ``no_reload``: after the ring's first fill the producer only signals
  the full barriers and loads nothing, so the consumers reuse stale K/V:
  the output is wrong (printed as ``limit_used``), and the time says what
  the K/V traffic from L2 costs.

The variants run in the order A B C D D C B A, so that drift on the card
shows.  Each prints one JSON line: device ms of 20 launches replayed from
a CUDA graph and TFLOP/s, at the starcoder2-7b serving prefill shape
(layer 0: B = 4, S = 8,192, 36 heads over 4 KV heads, d = 128, window
4,096) and at ``prefill_32k``'s sequence (B = 1, S = 32,768), and at the
serving shape the largest share of the smoke's ``attn_limit`` that the
output uses against the plain version.  The card's name and power limit
come first.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "flash_variants"
CU = Path("repro_torch/kernels/csrc/flash_attention.cu")

VARIANTS = {
    "committed": [],
    "two_stages": [("constexpr int kStages = 3;",
                    "constexpr int kStages = 2;")],
    "mask_all": [
        ("sm.step(sc, jb_lo * BN, jb_lo < jf_lo || jb_lo >= jf_hi);",
         "sm.step(sc, jb_lo * BN, true);"),
        ("sm.step(sc, j * BN, j < jf_lo || j >= jf_hi);",
         "sm.step(sc, j * BN, true);")],
    "no_reload": [
        ("        mbar_expect_tx(full_k(s), L::kTileKV);\n",
         "        if (i >= kStages) {\n"
         "          mbar_arrive(full_k(s));\n"
         "          mbar_arrive(full_v(s));\n"
         "          continue;\n"
         "        }\n"
         "        mbar_expect_tx(full_k(s), L::kTileKV);\n")],
}
H, K, D, WINDOW = 36, 4, 128, 4096
SHAPES = (("serve", 4, 8192), ("prefill_32k", 1, 32768))


def make_tree(name: str) -> Path:
    """A copy of src/repro_torch with the variant's edits applied."""
    src = OUT / name / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cu = src / CU
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit's anchor {old!r} is not in "
                             f"{CU} exactly once")
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def time_tree(name: str, src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    _build.library()

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"variant": name, "build_s": _build.build_seconds}
    for shape, B, S in SHAPES:
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        cache = torch.randn(2, B, S + 40, K, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
        k, v = cache[0, :, :S], cache[1, :, :S]  # slices of a KV cache

        def call():
            return flash_attention_cuda(q, k, v, causal=True, window=WINDOW)

        t = ms(call)
        pairs = B * sum(min(i + 1, WINDOW) for i in range(S))
        rec = {"ms": t, "tflops": 4 * D * H * pairs / t / 1e9}
        if shape == "serve":  # chip_smoke.attn_limit, tol 2e-2
            got = call().float()
            want = mha_ref(q, k, v, causal=True, window=WINDOW).float()
            a = want.abs()
            lim = 2e-2 * (a + (2 * a.mean(-1, keepdim=True)).clamp(max=1))
            rec["limit_used"] = float(((got - want).abs() / lim).max())
        out[shape] = rec
        del q, cache, k, v
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(time_tree(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    trees = {name: make_tree(name) for name in VARIANTS}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    failed = False
    for name in order:
        res = subprocess.run(
            [sys.executable, __file__, "--child", name, str(trees[name])],
            capture_output=True, text=True, timeout=600)
        print(res.stdout.strip(), flush=True)
        if res.returncode != 0:
            failed = True
            print(f"{name}: exit {res.returncode}\n{res.stderr[-3000:]}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
