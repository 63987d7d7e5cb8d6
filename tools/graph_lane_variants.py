#!/usr/bin/env python3
"""Time the min-plus Q-lane forms of the two graph kernels on one card.

    python3 tools/graph_lane_variants.py [--parent PARENT_SRC] [--lanes 1 4 8 20 32]

The inputs are TR_SMALL's (16,384 vertices, 8 partitions, B = 64):
instance 0's staged latency tiles, its local and boundary tile lists and
walk plans, and its converged SSSP state with its published boundary,
made once in this process and saved under ``build/graph_lane_variants/``
(git-ignored).  Each build of the kernels is timed in a process of its
own (two builds of the kernel library in one process interpose their
symbols):

* ``committed``: this tree's ``src``;
* ``parent``: with ``--parent``, the ``src`` directory of another tree
  (an earlier commit's, unpacked with ``git archive``), as it is.

* with ``--variants``, design variants of the lane walk: the committed
  sources with textual edits of ``csrc/blocked_walk.cuh`` (VARIANTS),
  copied to ``build/graph_lane_variants/<name>/`` and built there.

The builds run in the order A B C ... C B A (parent first, where there is
one), so that drift on the card shows.  For each Q in ``--lanes`` (lane
0 the converged state, the others moved by up to one unit, as
``chip_smoke.py`` makes its Q-lane states) each build prints one JSON
line per call shape: the min-plus local sweep and consume of
``spmv_blocked_cuda`` and of ``fused_step_cuda`` (the engine's shapes:
combine and vote), with ``ms``, device time per launch of 20 launches
replayed from one CUDA graph, ``walk``, the walk the launch took (where
the build counts it), and ``agrees``, whether the output equals the
plain version's (NaN where it has NaN, every other entry bit for bit).
The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "graph_lane_variants"
LANES = (1, 4, 8, 20, 32)
WALK = "repro_torch/kernels/csrc/blocked_walk.cuh"
CU = ("semiring_spmm.cu", "semiring_superstep.cu")
UNROLL = "#pragma unroll 2\n      for (int k = 4 * g; k < nr; k += 4 * G) {"
FOLD = ("      __syncthreads();  // every thread is done with this slot\n"
        "      if (tid == 0 && sw + kLaneStages < total) {")
BOUNDS = "__launch_bounds__(kLaneThreads, 2)"
LANE_THREADS = "constexpr int kLaneThreads = 256;"
MAC = "  return MinPlus::add(acc, x + w);\n}"

# name: [(file under src, old text, new text), ...]
VARIANTS = {
    # the walk without its fold: TMA stream, x copy, barriers, epilogue
    "no_fold": [(WALK, MAC, "  return acc;\n}")],
    # the min without NaN propagation (min.f32): what .NAN costs
    "min_no_nan": [(WALK, MAC, "  float r, s = x + w;\n"
                    "  asm(\"min.f32 %0, %1, %2;\" : \"=f\"(r) : \"f\"(acc), "
                    "\"f\"(s));\n  return r;\n}")],
    # every stage folded twice (min is idempotent: the same outputs): the
    # difference to committed is the fold's own time
    "fold_x2": [(WALK, UNROLL, "for (int rep = 0; rep < 2; ++rep) {\n" + UNROLL),
                (WALK, FOLD, "      }\n" + FOLD)],
    # the x values not read from memory (+inf in their place)
    "no_gather": [(WALK, "        if (lane < Q) {\n          const float* xl",
                   "        if (false) {\n          const float* xl")],
    "stages_2": [(WALK, "constexpr int kLaneStages = 3;",
                  "constexpr int kLaneStages = 2;")],
    "stages_4": [(WALK, "constexpr int kLaneStages = 3;",
                  "constexpr int kLaneStages = 4;")],
    # at most 128 registers a thread (two CTAs an SM), or none asked for,
    # or at most 80 (three CTAs an SM)
    "bounds_none": [(f"repro_torch/kernels/csrc/{f}", BOUNDS,
                     "__launch_bounds__(kLaneThreads)") for f in CU],
    "bounds_3": [(f"repro_torch/kernels/csrc/{f}", BOUNDS,
                  "__launch_bounds__(kLaneThreads, 3)") for f in CU],
    # CTAs of 512 or 384 threads (more row groups; at most 64 or 85
    # registers a thread for two CTAs an SM)
    "threads_512": [(WALK, LANE_THREADS, LANE_THREADS.replace("256", "512"))],
    "threads_384": [(WALK, LANE_THREADS, LANE_THREADS.replace("256", "384"))],
    "unroll_1": [(WALK, UNROLL, UNROLL.replace("unroll 2", "unroll 1"))],
    "unroll_4": [(WALK, UNROLL, UNROLL.replace("unroll 2", "unroll 4"))],
}


def cuda_ms(fn, reps=20, warm=3) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, its replay timed with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_inputs(path: Path) -> None:
    """TR_SMALL instance 0 through this tree's engine, saved to ``path``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.goffish_tr import TR_SMALL
    from repro_torch.core.algorithms import sssp
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.engine import (
        TemporalEngine, min_plus_program, source_init)
    from repro_torch.core.generator import generate_collection
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.semiring import INF, MIN_PLUS
    from repro_torch.core.superstep import _publish

    col = generate_collection(TR_SMALL)
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(
        tmpl, TR_SMALL.num_partitions, seed=TR_SMALL.seed),
        TR_SMALL.block_size)
    lat = col.edge_values(0, sssp.WEIGHT_ATTR)[None]
    eng = TemporalEngine(bg, device="cuda", use_pallas="spmv")
    tiles, btiles = eng.stage(lat, INF)
    res = eng.run(min_plus_program("sssp", init=source_init(0)),
                  pattern="sequential", tiles=tiles, btiles=btiles)
    x = torch.as_tensor(bg.scatter_vertex(res.final.astype(np.float32), INF),
                        device="cuda")
    dg = eng._device_graph(tiles[0], btiles[0], eng._index)
    b = _publish(x, dg, MIN_PLUS, eng.comm)
    rows, cols, brows, bcols = eng._index
    torch.save({
        "tiles": tiles[0].cpu(), "btiles": btiles[0].cpu(),
        "rows": rows.cpu(), "cols": cols.cpu(), "brows": brows.cpu(),
        "bcols": bcols.cpu(), "x": x.cpu(), "b": b.cpu(),
        "vmask": eng._tail[3].cpu(), "B": bg.block_size,
    }, path)


def same_bits(got, want) -> bool:
    import torch

    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def child(src: str, inputs: str, label: str, lanes) -> None:
    """Time one build (``src``) on the saved inputs; one JSON line per
    (Q, call)."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    d = {k: (v.cuda() if torch.is_tensor(v) else v)
         for k, v in torch.load(inputs).items()}
    B = d["B"]
    P, Vp = d["x"].shape
    nvb, nbb = Vp // B, d["b"].shape[-1] // B
    plan = to_device(walk_plan(d["cols"].cpu().numpy(), nvb,
                               chunk=default_chunk(B)), "cuda")
    bplan = to_device(walk_plan(d["bcols"].cpu().numpy(), nvb,
                                chunk=default_chunk(B)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    vm = d["vmask"].reshape(P, nvb, B)
    tl, btl = d["tiles"], d["btiles"]
    rows, cols, brows, bcols = d["rows"], d["cols"], d["brows"], d["bcols"]
    for Q in lanes:
        u = torch.rand((Q, P, Vp), generator=gen, device="cuda")
        u[0] = 0
        xq = d["x"] + u
        ub = torch.rand((Q,) + tuple(d["b"].shape), generator=gen,
                        device="cuda")
        ub[0] = 0
        bq = d["b"] + ub
        xs4 = xq.reshape(Q, P, nvb, B)
        b4 = bq.reshape(Q, 1, nbb, B)
        xref = torch.flip(xs4, (3,)).contiguous()
        calls = {
            "spmv local sweep": (
                lambda: spmv_blocked_cuda(tl, rows, cols, xq, MIN_PLUS,
                                          plan=plan),
                lambda: spmv_blocked_ref(tl, rows, cols, xq, MIN_PLUS)),
            "spmv consume": (
                lambda: spmv_blocked_cuda(btl, brows, bcols, bq[:, None],
                                          MIN_PLUS, n_out_blocks=nvb,
                                          plan=bplan),
                lambda: spmv_blocked_ref(btl, brows, bcols, bq[:, None],
                                         MIN_PLUS, n_out_blocks=nvb)),
            "fused sweep": (
                lambda: fused_step_cuda(tl, rows, cols, xs4, xs4, xs4, vm,
                                        MIN_PLUS, plan=plan),
                lambda: fused_step_ref(tl, rows, cols, xs4, xs4, xs4, vm,
                                       MIN_PLUS)),
            "fused consume": (
                lambda: fused_step_cuda(btl, brows, bcols, b4, xs4, xref, vm,
                                        MIN_PLUS, plan=bplan),
                lambda: fused_step_ref(btl, brows, bcols, b4, xs4, xref, vm,
                                       MIN_PLUS)),
        }
        for name, (kfn, pfn) in calls.items():
            k = spmv_blocked_cuda if name.startswith("spmv") else \
                fused_step_cuda
            before = dict(getattr(k, "launches_by_walk", {}))
            ko, po = kfn(), pfn()
            agrees = same_bits(ko[0], po[0]) if isinstance(ko, tuple) else \
                same_bits(ko, po)
            if isinstance(ko, tuple):
                agrees = agrees and torch.equal(ko[1], po[1])
            walk = [w for w, n in getattr(k, "launches_by_walk", {}).items()
                    if n > before.get(w, 0)]
            print(json.dumps({"variant": label, "Q": Q, "call": name,
                              "ms": cuda_ms(kfn),
                              "walk": walk[0] if walk else None,
                              "agrees": agrees}), flush=True)


def variant_src(name: str) -> str:
    """The committed ``src`` with VARIANTS[name]'s edits, under OUT."""
    import shutil

    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = dst / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {rel} has {text.count(old)} "
                             f"of {old!r}, not one")
        f.write_text(text.replace(old, new))
    return str(dst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="src directory of an earlier tree")
    ap.add_argument("--lanes", type=int, nargs="+", default=list(LANES))
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS), help="design variants")
    ap.add_argument("--child", nargs=3, metavar=("SRC", "INPUTS", "LABEL"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(*a.child, a.lanes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("graph_lane_variants: no CUDA device; this tool runs on the "
              "card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    inputs = OUT / "inputs.pt"
    make_inputs(inputs)
    builds = [("committed", str(ROOT / "src"))]
    builds += [(v, variant_src(v)) for v in a.variants]
    if a.parent:
        builds.insert(0, ("parent", str(Path(a.parent).resolve())))
    builds += builds[::-1]
    lanes = [str(q) for q in a.lanes]
    for label, src in builds:
        res = subprocess.run([sys.executable, __file__, "--lanes", *lanes,
                              "--child", src, str(inputs), label])
        if res.returncode != 0:
            print(f"graph_lane_variants: {label} failed "
                  f"(exit {res.returncode})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
