#!/usr/bin/env python3
"""Time design variants of the bf16 ring decode kernel on one card.

    python3 tools/decode_variants.py [--parent PARENT_SRC]

Each variant is the committed ``src/repro_torch`` with textual edits of
its sources, copied to ``build/decode_variants/`` (git-ignored), built
there and timed in a process of its own (two builds of the kernel
library in one process interpose their symbols):

* ``committed``: the sources as they are;
* ``cp_async``: the ring filled by the producer warp's 16-byte
  ``cp.async`` (each lane's copies counted on the stage's full barrier)
  instead of TMA boxes;
* ``bulk_rows``: the ring filled by one 1-D bulk copy (TMA, L2
  evict-first) per K row and per V row of the split, issued by the
  producer warp's lanes into rows padded to d + 8 elements, the stage's
  full barrier expecting the bytes of its valid rows only;
* ``pdl``: the combine launched as a programmatic dependent of the ring
  kernel, which triggers it at its start, so that the combine's launch
  overlaps the ring kernel (the combine waits for its writes);
* ``stages_4``, ``stages_7``: a ring of 4 or 7 K/V stages instead of two
  (7 fill the shared memory at d = 128);
* ``old_split_rule``: the first version's split count (enough CTAs for
  one per SM, rounded up, no split under 128 keys: 9 at the serving
  shape) with its even, unaligned shares of the range.

With ``--parent``, the ``src`` directory of another tree (an earlier
commit's, unpacked with ``git archive``) is timed as it is, under
``parent``, and with its split count forced to 8, under
``parent_8_splits``.

The variants run in the order A B C ... C B A, so that drift on the card
shows.  Each prints one JSON line, at the starcoder2-7b serving decode
shape (layer 0 of the first decode step: B = 4, 36 query heads over 4 KV
heads, d = 128, 8,193 tokens in a cache of 8,232 slots, window 4,096) and
at ``decode_32k``'s cache (B = 128, S = 32,768, random lengths, window
4,096): ``ms``, device time of 20 launches replayed from a CUDA graph
(back to back, so K/V that fit the 50 MB L2 may be read from it);
``cold_ms``, the same with a 256 MB read between launches, less the time
of those reads alone (what a caller that finds K/V out of L2 sees, as a
decode step does after the other layers); and, at the serving shape,
``eager_ms``, 20 calls from the host timed with CUDA events (the
wrapper's host work included), and the largest share of the smoke's
``attn_limit`` that the output uses against the plain version.  The card's name and power limit come first.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "decode_variants"
CU = "repro_torch/kernels/csrc/decode_attention.cu"
SCHEDULE = "repro_torch/kernels/decode_attention/schedule.py"

PRODUCER_TMA = """\
    if (lane == 0) {
      for (int i = 0; i < nblk; ++i) {
        const int s = i % R::kStages;
        mbar_wait(&empty[s], ((i / R::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], R::kStage);
        const uint32_t sk = smem_addr(ring + s * (R::kStage / 2));
        const uint32_t bar = smem_addr(&full[s]);
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(sk + h * KB * 128, &tm_k, bar, h * 64, kvh,
                      r.x + i * KB, b);
          tma_load_4d(sk + R::kTile + h * KB * 128, &tm_v, bar, h * 64, kvh,
                      r.x + i * KB, b);
        }
      }
    }
"""
# the whole producer warp copies 16-byte chunks with cp.async into the
# same swizzled stages, rows past the split's end zero-filled, and each
# lane's copies arrive on the stage's full barrier (32 arrivals)
PRODUCER_CP_ASYNC = """\
    {
      constexpr int CPR = D / 8, RPI = 32 / CPR;
      const int r0 = lane / CPR, cc = lane % CPR;
      for (int i = 0; i < nblk; ++i) {
        const int s = i % R::kStages;
        mbar_wait(&empty[s], ((i / R::kStages) & 1) ^ 1);
        const int base = r.x + i * KB, rows = min(KB, r.y - base);
        uint16_t* dk = ring + s * (R::kStage / 2);
        uint16_t* dv = dk + R::kTile / 2;
        const uint16_t* k0 = k + b * k_bs + (long long)kvh * D + cc * 8 +
                             (long long)base * k_rs;
        const uint16_t* v0 = v + b * v_bs + (long long)kvh * D + cc * 8 +
                             (long long)base * v_rs;
#pragma unroll
        for (int j = 0; j < KB / RPI; ++j) {
          const int row = r0 + j * RPI;
          const bool ok = row < rows;
          cp_async16(dk + kv_chunk(row, cc), ok ? k0 + row * k_rs : k0, ok);
          cp_async16(dv + kv_chunk(row, cc), ok ? v0 + row * v_rs : v0, ok);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                     :: "r"(smem_addr(&full[s])) : "memory");
      }
    }
"""
# one 1-D bulk copy per K and per V row of the split, spread over the
# producer warp's lanes; rows past the split's end are not copied
PRODUCER_BULK_ROWS = """\
    {
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(policy));
      for (int i = 0; i < nblk; ++i) {
        const int s = i % R::kStages;
        mbar_wait(&empty[s], ((i / R::kStages) & 1) ^ 1);
        const int base = r.x + i * KB, rows = min(KB, r.y - base);
        if (lane == 0) mbar_expect_tx(&full[s], rows * 4 * D);
        __syncwarp();
        uint16_t* dk = ring + s * (R::kStage / 2);
        uint16_t* dv = dk + R::kTile / 2;
        const uint32_t bar = smem_addr(&full[s]);
        for (int row = lane; row < rows; row += 32) {
          const long long key = base + row;
          const uint16_t* srcs[2] = {
              k + b * k_bs + key * k_rs + (long long)kvh * D,
              v + b * v_bs + key * v_rs + (long long)kvh * D};
          uint16_t* dsts[2] = {dk + kv_chunk(row, 0), dv + kv_chunk(row, 0)};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
                :: "r"(smem_addr(dsts[j])), "l"(srcs[j]), "r"(D * 2),
                   "r"(bar), "l"(policy) : "memory");
        }
      }
    }
"""
KV_CHUNK = """\
__device__ __forceinline__ int kv_chunk(int r, int c) {
  return (c >> 3) * (KB * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}"""
# the producer's source pointers and strides, for the variants that copy
# from the cache without tensor maps
RAW_KV_ARGS = [
    (CU, "    const __grid_constant__ CUtensorMap tm_v,\n",
     "    const __grid_constant__ CUtensorMap tm_v,\n"
     "    const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,\n"
     "    long long k_bs, long long k_rs, long long v_bs, long long v_rs,\n"),
    (CU, "      mk, mv, (const uint16_t*)q, lengths,",
     "      mk, mv, (const uint16_t*)k, (const uint16_t*)v, st[1], st[2],\n"
     "      st[3], st[4], (const uint16_t*)q, lengths,")]
STAGES = "  static constexpr int kStages = 2;"
# the combine launched as a programmatic dependent of the split kernel,
# which lets it launch at once; it waits for the split kernel's writes
COMBINE_LAUNCH = """\
  decode_combine_kernel<T><<<dim3(B * K, G), D, 0, s>>>(
      ws_acc, ws_ml, (T*)o, K, G, D, nsplit, o_bs);
  return cudaGetLastError();"""
COMBINE_PDL = """\
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K, G);
  cfg.blockDim = dim3(D);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, ws_acc, ws_ml,
                            (T*)o, K, G, D, nsplit, o_bs);"""
COMBINE_START = "  const int bk = blockIdx.x, g = blockIdx.y, dd = threadIdx.x;\n"
RING_START = "  const int nkeys = r.y - r.x, nblk = (nkeys + KB - 1) / KB;\n"
# name -> [(file under src/, old text, new text)]
VARIANTS = {
    "committed": [],
    "cp_async": [
        (CU, PRODUCER_TMA, PRODUCER_CP_ASYNC),
        (CU, "      mbar_init(&full[s], 1);\n      mbar_init(&empty[s], DW);",
         "      mbar_init(&full[s], 32);\n      mbar_init(&empty[s], DW);"),
        *RAW_KV_ARGS],
    "bulk_rows": [
        (CU, PRODUCER_TMA, PRODUCER_BULK_ROWS),
        # rows padded to D + 8 elements, no swizzle (D from the template)
        (CU, KV_CHUNK, "#define kv_chunk(r, c) ((r) * (D + 8) + (c) * 8)"),
        (CU, "  static constexpr int kTile = KB * D * 2;",
         "  static constexpr int kTile = KB * (D + 8) * 2;"),
        *RAW_KV_ARGS],
    "pdl": [
        (CU, COMBINE_LAUNCH, COMBINE_PDL),
        (CU, COMBINE_START,
         '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
         + COMBINE_START),
        (CU, RING_START,
         RING_START + '  asm volatile("griddepcontrol.launch_dependents;");\n')],
    "stages_4": [(CU, STAGES, "  static constexpr int kStages = 4;")],
    "stages_7": [(CU, STAGES, "  static constexpr int kStages = 7;")],
    "old_split_rule": [
        (SCHEDULE,
         "    return max(1, min(sms // max(batch_kv_heads, 1), "
         "-(-span // KB)))",
         "    return max(1, min(-(-sms // max(batch_kv_heads, 1)), "
         "-(-span // 128)))"),
        (CU,
         "  const int nb = ((n + KB - 1) / KB + nsplit - 1) / nsplit;\n"
         "  const int c0 = lo + split * nb * KB;\n"
         "  return make_int2(c0, max(c0, min(hi, c0 + nb * KB)));",
         "  const int chunk = (n + nsplit - 1) / nsplit;\n"
         "  const int c0 = lo + split * chunk;\n"
         "  return make_int2(c0, max(c0, min(hi, c0 + chunk)));")],
}
H, K, D, WINDOW = 36, 4, 128, 4096
# (name, batch, cache slots, lengths: an int for all, or None for random)
SHAPES = (("serve", 4, 8232, 8193), ("decode_32k", 128, 32768, None))
FLUSH_BYTES = 256 << 20
# trees timed as they are, with a fixed split count or their own (None)
PARENTS = {"parent": None, "parent_8_splits": 8}


def make_tree(name: str) -> Path:
    """A copy of src/repro_torch with the variant's edits applied."""
    src = OUT / name / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = src / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit's anchor {old!r} is not in "
                             f"{rel} exactly once")
        path.write_text(text.replace(old, new))
    return src


def time_tree(name: str, src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.decode_attention.ref import decode_ref

    _build.library()
    if PARENTS.get(name):
        kernel.num_splits = lambda *a, n=PARENTS[name]: n

    def ms(fn, reps=20, graph=True):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            run = g.replay
        else:
            def run():
                for _ in range(reps):
                    fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    total = torch.empty((), device="cuda")

    def read_flush():
        torch.sum(flush, dim=0, out=total)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"variant": name, "build_s": _build.build_seconds}
    for shape, B, S, length in SHAPES:
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        cache = torch.randn(2, B, S, K, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
        k, v = cache[0], cache[1]
        if length is None:
            lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32)
        else:
            lengths = torch.full((B,), length, dtype=torch.int32,
                                 device="cuda")
        span = min(S, WINDOW)

        def call():
            return kernel.decode_attention_cuda(q, k, v, lengths,
                                                window=WINDOW)

        def cold():
            read_flush()
            call()

        # an earlier tree may count no routes
        before = dict(getattr(kernel.decode_attention_cuda,
                              "launches_by_route", {}))
        call()
        after = getattr(kernel.decode_attention_cuda, "launches_by_route",
                        {})
        rec = {"ms": ms(call), "cold_ms": ms(cold) - ms(read_flush),
               "splits": kernel.num_splits(
                   B * K, span, torch.cuda.get_device_properties(
                       0).multi_processor_count),
               "route": [r for r in after if after[r] != before[r]]}
        if shape == "serve":  # chip_smoke.attn_limit, tol 2e-2
            rec["eager_ms"] = ms(call, graph=False)
            got = call().float()
            want = decode_ref(q, k, v, lengths, window=WINDOW).float()
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
    if len(sys.argv) not in (1, 3) or sys.argv[1:2] not in ([], ["--parent"]):
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else None
    import torch

    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    trees = {name: make_tree(name) for name in VARIANTS}
    if parent is not None:
        trees.update(dict.fromkeys(PARENTS, parent))
    order = list(trees) + list(trees)[::-1]
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
