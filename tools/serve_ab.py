#!/usr/bin/env python3
"""Serve starcoder2-7b from two source trees in turns on one card.

    python3 tools/serve_ab.py OTHER_SRC [--serves N]

``OTHER_SRC`` is the ``src`` directory of another tree (an earlier
commit's, unpacked with ``git archive`` into a git-ignored directory).
The trees run in the order other, this, this, other, each in a process of
its own that builds its own kernels, so that drift on the card and on
its host shows.  Each process builds starcoder2-7b at full width and
depth with random weights (seed 0, as ``chip_smoke.py``'s phase 8) and
has ``BatchedServer`` answer the smoke's traffic, 4 prompts of 8,192
tokens with 32 new tokens each at batch 4, ``N`` times (default 6), and
prints one line ``RESULT <src> [[prefill_s, decode_s], ...]``, the
server's host-clock ``stats`` of each serve, the first serve's included
(it warms the allocator and the kernels).  The card's name and power
limit come first, and last a JSON summary: per tree, the decode seconds
of the serves after each process's first, their least, median and
largest.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH, REQUESTS, BATCH, PROMPT, NEW = "starcoder2-7b", 4, 4, 8192, 32


def child(serves: int) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_model_params

    cfg = get_config(ARCH)
    model = init_model_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
               for _ in range(REQUESTS)]
    out, first = [], None
    for _ in range(serves):
        srv = BatchedServer(model, batch_size=BATCH,
                            max_len=PROMPT + NEW + 8)
        done = srv.serve([Request(rid=i, tokens=p, max_new=NEW)
                          for i, p in enumerate(prompts)])
        toks = [r.out for r in done]
        if first is None:
            first = toks
        if toks != first or not srv.stats["finite"]:
            raise SystemExit("serve_ab: a serve gave other tokens or "
                             "non-finite logits")
        out.append([srv.stats["prefill_s"], srv.stats["decode_s"]])
    print(f"RESULT {os.environ['PYTHONPATH']} {json.dumps(out)}",
          flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        child(int(args[1]))
        return 0
    serves = 6
    if "--serves" in args:
        i = args.index("--serves")
        serves = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other, this = str(Path(args[0]).resolve()), str(ROOT / "src")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    decode = {other: [], this: []}
    for src in (other, this, this, other):
        run = subprocess.run(
            [sys.executable, __file__, "--child", str(serves)],
            env=dict(os.environ, PYTHONPATH=src), capture_output=True,
            text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        decode[src] += [d for _, d in json.loads(lines[-1].split(" ", 2)[2])
                        [1:]]
    print(json.dumps({
        ("other" if src == other else "this"): {
            "src": src, "decode_s": v, "least": min(v),
            "median": statistics.median(v), "largest": max(v)}
        for src, v in decode.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
