#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. the graph kernels against their plain PyTorch versions on the card,
   both semirings, B in {32, 64, 128}, padding, an empty structure,
   ``nnz`` and the fused call shapes (with and without the combine and
   the vote): min-plus bitwise (same inf pattern), plus-mul within the
   limit of :func:`plus_mul_limit`, halt votes exactly equal; and a
   cluster shard's call shapes (``shard_sweep``: P_local = 4 at B = 64,
   each shard with its own walk plans), with a control that must fail
   (a shard walked with the other shard's plan);
4. the attention kernels against theirs on FLASH_CASES and DECODE_CASES
   (the sweeps of ``tests/test_kernels.py`` plus ragged tails, G = 9,
   windows past the sequence, length-1 caches, many splits), within
   :func:`attn_limit` (the reference's 2e-5 float32 / 2e-2 bf16, with
   the absolute part scaled to each output row);
5. the graph main path at TR_SMALL (16,384 vertices, 48 instances, 8
   partitions, B=64), dense layout, through ``TemporalEngine.run``:
   sequential SSSP in ``spmv`` and ``fused`` mode (bitwise equal, and
   equal to the numpy oracle), independent PageRank (10 iterations) in both
   modes (within :func:`plus_mul_limit` of each other, and within 1e-4
   relative of the float64 oracle), one eventually/``merge="mean"`` run
   and one sparse-layout run on a few instances; the graph kernels'
   launches are counted by call shape (:func:`call_shapes`);
5b. the query axis (``query_phase``): SSSP with 32 sources (QUERY_LANES)
   as one engine pass over phase 5's staged batch, all 48 instances, in
   spmv and fused mode: every lane bitwise equal across the modes and to
   its own single-source run (all 32 run alone and timed), lane 0 to
   phase 5's run; the batched run's launches equal its vote reads, at
   least the slowest lanes' count and under the single runs' sum; its
   launches are counted by call shape on their own, and both kernels
   must have launched in their Q-lane form; on every graph path the
   launches by walk (``launches_by_walk``) must match the launches by
   call shape, every min-plus call of ``walk_plan.LANE_WALK_MIN`` lanes
   or more on the lane walk;
5d. the five examples (``examples_phase``): ``repro_torch.examples``'
   quickstart, temporal_sssp, vehicle_tracking, serve_lm and train_lm
   (about 20M parameters, 200 steps, a crash and a resume) with
   ``device="cuda"`` in this process, at their own sizes and asserts
   live; each one's seconds and launches (the attention kernels', the
   flash backward's included, by route; train_lm's backward all on the
   bf16 wgmma route);
6. the same graph path from a GoFS deployment (``gofs_path``): the
   collection deployed with ``deploy_collection`` (latency tile maps and
   the delta chain) into a temporary directory; host iBSP SSSP
   (``sssp.run_host``) on the ``GoFSStore`` over its first time pack
   (HOST_IBSP_PACKS; listed on the ``gofs path cuts`` line), against the
   oracle over the same instances; the
   dense ``load_blocked`` batch equal to the in-memory fill, and
   sequential SSSP from it in both kernel modes equal to phase 5's runs;
   sparse loads from the delta chain and from the full value slices over
   the first time pack (SPARSE_LOAD_PACKS; on the cuts line), equal to
   each other, with SSSP on the delta batches equal to the dense store
   run's first instances; PageRank from the store's activity within
   :func:`plus_mul_limit` of phase 5's; then the Gopher session on the
   same deployment (``session_phase``): ``GopherSession(store)`` plans
   SSSP (dense, dense comm, async, no delta, cold, ``spmv``, stacked),
   prints ``explain()``, and runs it streamed from the store, bitwise
   equal to the dense store run; the same plan in ``fused`` mode,
   bitwise equal to the fused run; ``run_many`` of sssp, nhop (4 hops)
   and pagerank (10 iterations) with its staging report, sssp bitwise,
   pagerank within :func:`plus_mul_limit` of the store PageRank, nhop's
   histograms equal to ``nhop.oracle``; and the sparse override (the
   streamed delta route, fused) over the first time pack
   (SESSION_DELTA_PACKS, on the ``gofs path cuts`` line), bitwise equal
   to the auto plan's first instances, with its source bytes beside its
   staged bytes; then the query axis through the session:
   SSSP with phase 5b's 32 sources streamed from the store, every lane
   bitwise equal to phase 5b's; N-hop with 4 sources, lane 0 equal to
   the ``run_many`` histograms and the others to ``nhop.oracle`` on the
   first and last instance; ``tracking`` of the plate seen in the most
   timesteps, its trace equal to host iBSP ``tracking.run_host`` on the
   store; each step's wall time, the seconds the engine waited on chunks
   against the seconds it computed, peak pinned bytes, peak device
   memory and host peak RSS.  The graph kernels'
   launches on this path are counted by call shape, and the session's
   on their own;
6c. the cluster runtime on the same deployment (``cluster_phase``):
   two worker processes of ``repro_torch.launch.cluster_graph`` share the
   card over the TCP exchange, each owning 4 of the 8 partitions and
   staging its shard through ``shard_stream``; their SSSP and PageRank
   bitwise equal to phase 6's session runs, their staged bytes below the
   single-process session's; each worker counts its launches by call
   shape and by walk, and runs SSSP again in the kernel mode its auto
   plans did not launch over the first time pack
   (CLUSTER_OTHER_MODE_PACKS, on the ``gofs path cuts`` line), bitwise
   equal to its first SSSP's first instances, so both kernels run at
   their P_local = 4 shapes; then a checkpointed SSSP (spans of 12)
   killed in its second span in a child process, exactly one snapshot committed,
   resumed bitwise equal to phase 6's session SSSP.  Records: seconds
   per worker, the exchange's operations and bytes, staged bytes per
   host, host peak RSS, the resume's seconds;
6d. the mesh (``mesh_phase``) on the same deployment: rank processes on
   the one card (:func:`mesh_worker`, ``--mesh-worker``), each with its
   own CUDA context, the in-memory runs of (b) and (c) over the first
   time pack (MESH_MEMORY_PACKS) and their runs from the store over the
   first time pack too (MESH_STORE_PACKS; both depth cuts on the ``mesh
   path cuts`` line): (a) a (1, 1)
   mesh with ``backend="nccl"``, over every instance — the
   only place the NCCL code runs, since NCCL refuses two ranks on one
   device — SSSP through ``GopherSession(store, mesh=...)``, streamed
   from the deployment, bitwise phase 5's; (b) ``model = 2`` under gloo,
   4 partitions a rank: sequential SSSP in spmv and fused mode and SSSP
   with phase 5b's 32 sources, bitwise phases 5 and 5b, independent
   PageRank within :func:`plus_mul_limit` of phase 5's, under
   ``dense``, ``ring`` and ``ring-rs``, SSSP streamed from the store
   through the session, bitwise, and a control whose combine drops the
   peer's partial, which must fail (its launches are counted apart from
   the path's); (c) ``data = 2`` under gloo, half the instances a rank:
   ``pagerank_temporal`` (ranks and ``merged``) within the limit of
   phase 5's PageRank and its mean, and independent SSSP under the ring
   (its loop synced over data) and streamed from the store, bitwise
   phase 5's eventually run.  Every rank's results equal rank 0's, each
   rank's fills, in memory and streamed, are exactly its share of a
   batch, and the exchange's bytes per superstep are printed beside
   ``boundary_exchange_bytes``'s; records: seconds per rank and run,
   host peak RSS and peak device memory per rank, exchange operations
   and bytes, launches by call shape and by walk (summed over the
   ranks);
6b. streaming ingestion and warm serving (``stream_phase``), after phase
   6 has removed its deployment: the first time pack of TR_SMALL (20
   instances, STREAM_FIRST; a depth cut on the ``stream path cuts``
   line) deployed with phase 6's knobs, then two appends of 4 instances from
   this thread (the first opens a new time pack, the second rewrites
   it) while a ``GopherService`` (a staging budget that holds the batch,
   one admission of up to 36 queries) serves: phase 5b's 32 SSSP
   sources before the appends, each lane bitwise equal to phase 5b's
   over instances 0-19; the same 32 and N-hop with 4 sources in one
   admission after them, every lane equal to phase 5b's over instances
   0-27 and the N-hop lanes to phase 6's session's; its ``sssp``
   subscription delivers full, incremental, incremental (20, 4, 4 new
   instances), the last equal to phase 6's cold session SSSP over those
   28 instances (values, final, supersteps, sweeps); a second session with ``use_pallas="fused"`` tails the same
   store to the same updates; after each append the staging cache
   stages only the new instances' fill.  Records (each with the card):
   deploy, append seconds and bytes written, free disk, refresh,
   extension and re-upload seconds, tail seconds, the service's
   latencies and batches, host peak RSS and peak device memory.  Its
   launches are counted by call shape and by walk: the 32-lane batches
   on the lane walk, N-hop's 4 lanes in groups of 4, the tails one lane;
7. each graph kernel at that path's shapes, with the engine's walk
   plans, and at each cluster shard's P_local = 4 partitions with the
   shard's own plans and phase 6c's launches: device time (20 calls
   replayed from one CUDA graph) and
   eager-call time, the plain version's device time, the bound and its
   share, and, for plus-mul, one PyTorch call computing the same
   function (a dense batched product); then a skewed control, partition
   0's boundary runs gathered into one output block, held against plain
   and timed; then each call shape in its Q-lane form at Q = 1, 4, 20
   and 32 (QUERY_SWEEP), min-plus bitwise and plus-mul within
   :func:`plus_mul_limit`, timed beside the plain version and, for
   plus-mul, ``torch.bmm`` over the lanes, each row naming the walk it
   launched; a skewed control at Q = 32; the lane walk at Q = 20 and 32
   on tiles with signed-zero weights and a -inf and a NaN weight, with
   lanes of signed zeros, NaN and -inf, against the plain version
   (:func:`same_bits`) and lane by lane against the one-lane kernel;
   the two-tile ±0 control (every walk gives -0 in both tile orders);
   MIN_PLUS's plain folds on the card on ±0 in both orders;
   and wrong controls that must fail the comparison (lanes rolled by
   one; a plus-mul tile dropped). Bounds: bytes over HBM bandwidth, or
   FP32 instructions (an add-min pair is two, an FMA one) over FP32_ISSUE,
   whichever is larger;
8. the LM serving path: starcoder2-7b at full width and depth, random
   weights, ``BatchedServer`` answering 4 prompts of 8,192 tokens with 32
   new tokens each (finite logits, no padded-vocab token, a second run
   giving the same tokens, every prefill flash launch on the bf16 wgmma
   route, every decode launch on the bf16 ring route), then a
   ``torch.profiler`` breakdown of one prefill and four decode steps;
9. teacher forcing at S = 8,192: prefill S + 1 against prefill S then
   decode 1, logits within 5e-2;
8b. the MoE family serving (``moe_serve``), after starcoder2-7b is
   freed: dbrx-132b cut to 4 of its 40 layers and llama4-maverick-400b-a17b
   to one group (a dense and a MoE layer), both at full width with random
   weights, one model on the card at a time (MOE_CUTS, printed on the
   ``moe path cuts`` line).  Each: ``BatchedServer`` with starcoder2's
   traffic (4 prompts of 8,192 tokens, 32 new, batch 4); its parameter
   count against ``param_count()`` of the cut config (plus the padded
   vocabulary rows and LayerNorm biases it leaves out); every prefill
   launch of kernel 3 on the bf16 wgmma route and every decode launch of
   kernel 4 on the bf16 ring route, layers x prefills and layers x decode
   steps; finite logits; a second serve giving the same tokens; each MoE
   layer's share of (token, expert) entries dropped for capacity in the
   prefill; kernels 3 and 4 at the serve's layer-0 shapes (G = 6 and 5,
   no window) against their plain versions within :func:`attn_limit`,
   with wrong controls that need no window (the causal edge one key off,
   the newest key lost, the oldest 32 keys dropped, query heads on the
   wrong KV heads); a ``torch.profiler`` breakdown of one prefill and four decode
   steps; teacher forcing at S = 1,024 on a copy of the config that
   drops nothing (capacity factor 64), within 5e-2; and the layer check:
   ``moe_apply_local`` on the first MoE layer, 256 tokens, against a
   token-by-token plain version whose kept set is recomputed on the host,
   within :func:`attn_limit` per token, at the config's capacity and at
   one that drops (asserted), with two wrong controls that must fail
   (gates not renormalised; dropped entries written by assignment);
8c. the audio family serving (``audio_serve``): whisper-medium at full
   width and depth (24 encoder and 24 decoder layers, d_model 1,024, 16
   heads, MHA, head dim 64), random weights and seeded random frames of
   8 clips of 30 s (8 x 1,500 x 1,024), ``BatchedServer`` answering 8
   prompts of 224 tokens with 64 new tokens each at batch 8 (AUDIO_*;
   the ``audio path cuts`` line is empty).  Prefill seconds split into
   the encoder and the decoder, decode seconds, tokens/s, peak memory,
   finite logits; kernel 3 launched 72 times (24 encoder, 24
   self-attention, 24 cross-attention), all on the bf16 wgmma route,
   kernel 4 63 x 48 times (self and cross a layer a step), all on the
   bf16 ring route; a second serve giving the same tokens; kernels 3 and
   4 at layer 0 of the five calls (the encoder, non-causal over 1,500
   frames; cross prefill, 224 over 1,500; self prefill; self decode;
   cross decode with every length 1,500) against their plain versions
   within :func:`attn_limit`, with wrong controls (a causal encoder, the
   ragged last key block dropped, the causal edge one key off, the
   newest key lost, the query heads on the wrong KV heads), and the
   cross decode again with its last frame's key planted on each query,
   where the last frame or the ragged last 64-key block lost must fail;
   teacher forcing at S = 224 within 5e-2; a profile of one
   prefill and four decode steps; then (``audio_timing``) each of the
   five calls timed beside its plain version, SDPA's flash backend and
   the bound;
10. each attention kernel at the serving run's layer-0 shapes and at the
   ``prefill_32k`` / ``decode_32k`` shapes: held against the plain
   version, with controls (the plain version with the window edge or the
   causal edge one key off, or a 32-key block dropped) that must fail the
   same limit; device, eager, plain, bound and SDPA (memory-efficient
   backend, and for flash also the cuDNN backend where it takes these
   inputs; yardsticks only) times, and the decode kernel's split-count
   sweep (1, 2, 4, 8, 16 splits and the schedule's own count).  The
   decode times are taken with K/V out of L2 (``cold_ms``), as a decode
   step finds them, and also back to back (``warm_ms``); then the
   ``kernels`` JSON line for all five kernels (the attention kernels'
   with their launches by route, phase 8b's by model, and phase 8c's
   launches and calls under ``audio_launches`` and ``audio_calls``);
11. LM training (``train_path``): starcoder2-7b at full width (d_model
   4,608, 36 heads over 4, d_ff 18,432, vocab 49,152, window 4,096) cut
   to 4 layers (1,321,288,704 parameters), ``train_loop`` for 4 steps of
   4 sequences of 4,096 tokens (TRAIN_4K's length), bf16 compute over
   float32 masters and moments, ``remat="full"``; every loss and
   gradient norm finite, no step skipped, kernel 3 launched twice a
   layer a step (the recompute) on the bf16 wgmma route and the backward
   once a layer a step, on its bf16 wgmma route; one
   ``AsyncCheckpointer`` snapshot restored bit
   for bit and deleted; NaN masters skipped with the state bitwise
   unchanged.  Then (``train_kernel_report``) the flash backward against
   its plain version over BWD_CASES within :func:`grad_limit` (its three
   routes, each case on the route its dtype and head dim pick; causal
   and windowed cases, and cases without the mask at whisper's shapes,
   Sq = Skv = 1,500 and 448 or 9 over 1,500, and on the other routes),
   each case
   launched twice bit for bit, kernel 3's ``lse`` output (the output bit
   for bit the output without it, ``lse`` within 1e-5 of the plain
   log-sum-exp), two wrong backwards (no window mask, no D term) that
   must fail the limit, and both kernels at the training layer's shape
   (the backward held there too within the limit) timed beside the plain
   versions, the bound and SDPA (the backward's three launches, D, dK/dV
   and dQ, also apart): SDPA on the flash backend with
   ``is_causal`` where the window does not cut, and with the mask on the
   memory-efficient backend;
11b. MoE training (``moe_train_path``), one model on the card at a time,
   each at full width, TRAIN_4K's 4,096 tokens, bf16 compute over
   float32 masters and bfloat16 moments, through ``train_loop`` with two
   micro-batches a step (MOE_TRAIN_CUTS, on the ``moe_train cuts``
   line): dbrx-132b with 1 of 40 layers and 8 of 16 experts (top 4,
   capacity factor 1.25), 4 x 4,096 tokens a step, ``remat="full"``, 4
   steps; llama4-maverick-400b-a17b with one group (a dense layer, then
   a MoE layer with 8 of 128 experts and the shared expert), 2 x 4,096
   tokens, ``remat="dots"``, 3 steps.  Each: its parameter count; every
   step's loss, ce and aux finite, aux > 0, none skipped; each dispatch
   over one micro-batch, the recompute dropping the forward's entries;
   kernel 3 and the backward launched as the policy implies, all on the
   bf16 wgmma route; one more step under ``torch.profiler`` with peak
   memory; both kernels at layer 0's training shapes (G = 6 and 5,
   causal, no window) against their plain versions, kernel 3 relaunched
   giving the training forward's bits, with two wrong controls each (the
   causal edge one key off, the wrong KV heads); the MoE layer's
   gradients (x, router, experts, shared expert) against the token loop
   within :func:`grad_limit`, at the config's capacity and at one that
   drops, with two wrong controls; and the policy's recompute by op
   count against ``remat="none"`` (under ``dots`` the experts' ``bmm``s
   and kernel 3 again, no ``mm``);
11c. audio training (``audio_train_path``): whisper-medium at full width
   and depth (24 encoder and 24 decoder layers, 811,323,392 parameters),
   weights from seed 0, bf16 compute over float32 masters and moments,
   ``remat="full"``, through ``make_train_step`` for 3 steps of 4 clips
   of 1,500 seeded random frames with 448-token transcripts from
   ``SyntheticLMDataset`` (AUDIO_TRAIN_*; the ``audio_train cuts`` line
   is empty); every loss and gradient norm finite, no step skipped;
   kernel 3 launched 144 times a step and the backward 72 (the encoder's
   no-mask self-attention, the decoder's causal self-attention and its
   cross-attention, 448 over 1,500 frames, in each of 24 layers; kernel
   3 again in each layer's recompute), all on the bf16 wgmma route; one
   more step under ``torch.profiler`` with peak memory; one
   ``AsyncCheckpointer`` snapshot restored bit for bit and deleted; the
   encoder's and the cross-attention's layer-0 calls (as the step gave
   them to the backward) through kernel 3 with ``lse`` (bit for bit the
   training forward's) and the backward against their plain versions,
   with wrong controls (the causal mask applied, Skv taken as Sq, and,
   with the last frame's key planted on every query, the ragged last
   128-key block dropped); then (``audio_train_timing``) the backward at
   both shapes timed beside its plain version, the bound and SDPA's
   flash backward without a mask; the ``kernels`` line's kernel-3 and
   backward rows gain ``audio_train_launches`` and ``audio_train_calls``;
12. the card's line again and the last line: ``{"ok": true, "device":
    {...}}``.

Each main path (graph, query, GoFS graph, the session within it, the
stream phase, serving, MoE serving, audio serving, training, MoE
training, audio training) runs with
every kernel's launch count
set to 0
just before it
and read just after; a kernel of the path that was not launched fails
the smoke.

It imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Plus-mul tolerance.  tests/test_kernels.py:46 holds plus-mul to rtol =
# atol = 2e-5 on values of order 1.  PageRank's values are near 1/V, where
# that atol is larger than the values themselves, so the absolute part is
# scaled to the data (see plus_mul_limit).
PLUS_MUL_TOL = 2e-5
# PageRank against the float64 oracle, relative in the same way
ORACLE_TOL = 1e-4
# HBM bandwidth of the one card this smoke has run on (H100 SXM data
# sheet), bytes/s
HBM_CARD, HBM_RATE = "H100 80GB HBM3", 3.35e12
# FP32 instructions a second on the CUDA cores of that card: the data
# sheet's 67 TFLOP/s counts an FMA as two operations (132 SMs x 128 lanes
# x 1.98 GHz); an add or a min is one instruction, as an FMA is
FP32_ISSUE = 67e12 / 2
# lanes of the Q-lane kernel sweep (phase 7): one, N-hop's four,
# tracking's twenty, the query phase's thirty-two
QUERY_SWEEP = (1, 4, 20, 32)


class SmokeFailure(AssertionError):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def hbm_rate(name: str) -> float:
    need(HBM_CARD in name, f"no HBM bandwidth on record for {name!r} (only "
                           f"{HBM_CARD!r}); add its data-sheet rate")
    return HBM_RATE


def plus_mul_limit(ref, tol=PLUS_MUL_TOL):
    """Elementwise limit on |got - ref| for plus-mul results: ``tol *
    (|ref| + min(1, mean |ref|))``.  On values of order 1 that is the JAX
    tests' rtol = atol = ``tol``; on smaller data the absolute part shrinks
    with the data, so a kernel that drops terms or sums in bf16 or TF32
    fails on PageRank's values too."""
    a = ref.abs()
    return tol * (a + min(1.0, float(a.mean()) if a.numel() else 1.0))


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def compare(kern, plain, sr_name: str, what: str):
    """Hold a kernel output against its plain version.  Returns the max
    abs error over finite entries (the inf pattern must match) and the
    largest share of the limit that any entry used (0 for min-plus)."""
    import torch

    k, p = kern.float(), plain.float()
    need(k.shape == p.shape, f"{what}: shape {tuple(k.shape)} vs "
                             f"{tuple(p.shape)}")
    fin_k, fin_p = torch.isfinite(k), torch.isfinite(p)
    need(torch.equal(fin_k, fin_p), f"{what}: inf/nan pattern differs")
    need(torch.equal(torch.isnan(k), torch.isnan(p)),
         f"{what}: nan pattern differs")
    need(torch.equal(k[torch.isinf(k)], p[torch.isinf(p)]),
         f"{what}: infinities differ")
    diff = (k[fin_k] - p[fin_p]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if sr_name == "min_plus":
        need(torch.equal(k.view(torch.int32), p.view(torch.int32)),
             f"{what}: min-plus not bitwise (max err {err})")
        return err, 0.0
    used = float((diff / plus_mul_limit(p[fin_p])).max()) \
        if diff.numel() else 0.0
    need(used <= 1.0, f"{what}: plus-mul error {err} is {used:.3g}x the "
                      f"limit of plus_mul_limit")
    return err, used


def same_bits(kern, plain, what):
    """Min-plus controls that hold NaN: NaN where the plain version has
    NaN, every other entry bit for bit (-0 is not +0).  NaN payloads are
    not compared: the kernels' min.NaN gives the canonical NaN where
    torch.minimum passes an input NaN through."""
    import torch

    need(kern.shape == plain.shape, f"{what}: shape {tuple(kern.shape)} vs "
                                    f"{tuple(plain.shape)}")
    nan = torch.isnan(plain)
    need(torch.equal(torch.isnan(kern), nan), f"{what}: nan pattern differs")
    need(torch.equal(kern[~nan].view(torch.int32),
                     plain[~nan].view(torch.int32)),
         f"{what}: min-plus not bitwise")


def walk_counts():
    """The graph kernels' launches so far by walk (``launches_by_walk``):
    {kernel: {walk: launches}}."""
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda

    return {k.__name__: dict(k.launches_by_walk)
            for k in (spmv_blocked_cuda, fused_step_cuda)}


def check_walks(what, shapes, before, after):
    """The launches of a path by walk (``after`` less ``before``, from
    :func:`walk_counts`) against its launches by call shape: each call
    shape's launches on the walk that ``walk_plan.walk_form`` gives its
    lanes and semiring (every min-plus call of ``LANE_WALK_MIN`` lanes or
    more on the lane walk).  Returns the launches by walk."""
    import re

    from repro_torch.kernels.walk_plan import walk_form

    out = {}
    for kernel, walks in after.items():
        got = {w: n - before[kernel][w] for w, n in walks.items()}
        want = dict.fromkeys(got, 0)
        for (k, call), n in shapes.items():
            if k == kernel:
                m = re.search(r" Q=(\d+)", call)
                sr = "min_plus" if "min_plus" in call else "plus_mul"
                want[walk_form(int(m.group(1)) if m else 1, sr)] += n
        need(got == want, f"{what}: {kernel} launches by walk {got}, by "
                          f"call shape {want}")
        out[kernel] = got
    return out


def random_structure(rng, P, T_valid, T, nvb_out, nvb_in):
    import numpy as np

    rows = np.full((P, T), -1, np.int32)
    cols = np.full((P, T), -1, np.int32)
    for p in range(P):
        n = int(T_valid[p])
        cols[p, :n] = np.sort(rng.integers(0, nvb_out, n))
        rows[p, :n] = rng.integers(0, nvb_in, n)
    return rows, cols


def random_tiles(rng, rows, B, density, zero):
    import numpy as np

    P, T = rows.shape
    tiles = np.full((P, T, B, B), zero, np.float32)
    live = (rng.random((P, T, B, B)) < density) & (rows >= 0)[..., None, None]
    tiles[live] = rng.random(int(live.sum())).astype(np.float32)
    return tiles


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_sweep(device="cuda", seed=0):
    """Returns the number of comparisons made."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref

    rng = np.random.default_rng(seed)
    n = 0

    def t(a):
        return torch.as_tensor(a, device=device)

    for B in (32, 64, 128):
        for sr in (MIN_PLUS, PLUS_MUL):
            for density in (0.05, 0.5):
                P, T, nvb, nbb = 3, 12, 5, 7
                tv = rng.integers(0, T + 1, P)
                tv[0] = T  # one partition with no padding at all
                rows, cols = random_structure(rng, P, tv, T, nvb, nvb)
                tiles = random_tiles(rng, rows, B, density, sr.zero)
                x = rng.random((P, nvb * B)).astype(np.float32)
                if sr is MIN_PLUS:
                    x[0, :B] = np.inf  # unreached vertices
                args = (t(tiles), t(rows), t(cols), t(x), sr)
                tag = f"spmv B={B} {sr.name} d={density}"
                compare(spmv_blocked_cuda(*args), spmv_blocked_ref(*args),
                        sr.name, tag)
                # single-partition form
                one = (t(tiles[1]), t(rows[1]), t(cols[1]), t(x[1]), sr)
                compare(spmv_blocked_cuda(*one), spmv_blocked_ref(*one),
                        sr.name, tag + " single")
                # nnz: the valid count, and a shorter walk
                for nz in (tv, np.maximum(tv - 2, 0)):
                    nzt = t(nz.astype(np.int32))
                    compare(spmv_blocked_cuda(*args, nnz=nzt),
                            spmv_blocked_ref(*args, nnz=nzt), sr.name,
                            tag + f" nnz={nz.tolist()}")
                # shared state (boundary consume), other out-block count
                brows, bcols = random_structure(rng, P, tv, T, nvb, nbb)
                btiles = random_tiles(rng, brows, B, density, sr.zero)
                b = rng.random((1, nbb * B)).astype(np.float32)
                bargs = (t(btiles), t(brows), t(bcols), t(b), sr)
                compare(spmv_blocked_cuda(*bargs, n_out_blocks=nvb),
                        spmv_blocked_ref(*bargs, n_out_blocks=nvb), sr.name,
                        tag + " shared")
                # fused: sweep, consume (shared x_in), plain spmv shape
                xs = t(x.reshape(P, nvb, B))
                xr = t(rng.random((P, nvb, B)).astype(np.float32))
                vm = t(rng.random((P, nvb, B)) < 0.9)
                zero = torch.full_like(xs, sr.zero)
                b3 = t(b.reshape(1, nbb, B))
                loc, bnd = (t(tiles), t(rows), t(cols)), \
                    (t(btiles), t(brows), t(bcols))
                shapes = {
                    "sweep": (*loc, xs, xs, xs),
                    "consume": (*bnd, b3, xs, xr),
                    "spmv": (*loc, xs, zero, xs),
                    # PageRank's step: no combine, no vote
                    "spmv no vote": (*loc, xs, None, None),
                    "consume no vote": (*bnd, b3, None, None),
                    "consume combine no vote": (*bnd, b3, xs, None),
                }
                for name, a in shapes.items():
                    m = None if a[5] is None else vm
                    ko, kc = fused_step_cuda(*a, m, sr, n_out_blocks=nvb)
                    po, pc = fused_step_ref(*a, m, sr, n_out_blocks=nvb)
                    compare(ko, po, sr.name, f"fused {name} {tag}")
                    need((kc is None and pc is None) or torch.equal(kc, pc),
                         f"fused {name} {tag}: votes differ")
                n += 12
        # empty structure: every output block gets the semiring zero
        for sr in (MIN_PLUS, PLUS_MUL):
            rows = np.full((2, 4), -1, np.int32)
            tiles = np.full((2, 4, B, B), sr.zero, np.float32)
            x = np.ones((2, 3 * B), np.float32)
            y = spmv_blocked_cuda(t(tiles), t(rows), t(rows), t(x), sr)
            need(bool((y == sr.zero).all()), f"empty B={B} {sr.name}")
            xs = t(x.reshape(2, 3, B))
            vm = torch.ones_like(xs, dtype=torch.bool)
            xo, ch = fused_step_cuda(t(tiles), t(rows), t(rows), xs, xs,
                                     xs + 1, vm, sr)
            need(torch.equal(xo, xs) and bool((ch == 1).all()),
                 f"empty fused B={B} {sr.name}")
            n += 2
    n += shard_sweep(device, rng)
    if device == "cuda":
        torch.cuda.synchronize()
    return n


# a cluster shard's call shapes (phase 6c): P_local = 4 of TR_SMALL's 8
# partitions at B = 64, with runs of a shard's size (NVB, NBB, T)
SHARD_SHAPE = dict(P=4, B=64, nvb=32, nbb=40, T=160)


def shard_sweep(device, rng):
    """Phase 3's P_local = 4 cases: a random 8-partition structure cut
    into two shards of 4, each shard's calls (both kernels, both
    semirings, the engine's call shapes) with its own walk plans against
    the plain version; then a control that must fail: shard 0's tiles
    walked with shard 1's plan.  Returns the comparisons made."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    P, B, nvb, nbb, T = (SHARD_SHAPE[k] for k in ("P", "B", "nvb", "nbb",
                                                  "T"))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def plan_of(cols):
        return to_device(walk_plan(cols, nvb, chunk=default_chunk(B)),
                         device)

    n = 0
    for sr in (MIN_PLUS, PLUS_MUL):
        tv = rng.integers(T // 2, T + 1, 2 * P)
        rows, cols = random_structure(rng, 2 * P, tv, T, nvb, nvb)
        brows, bcols = random_structure(rng, 2 * P, tv, T, nvb, nbb)
        tiles = random_tiles(rng, rows, B, 0.05, sr.zero)
        btiles = random_tiles(rng, brows, B, 0.05, sr.zero)
        x = rng.random((2 * P, nvb * B)).astype(np.float32)
        b = rng.random((1, nbb * B)).astype(np.float32)
        vm = t(rng.random((P, nvb, B)) < 0.9)
        plans = {}
        for lo in (0, P):
            sl = slice(lo, lo + P)
            loc = (t(tiles[sl]), t(rows[sl]), t(cols[sl]))
            bnd = (t(btiles[sl]), t(brows[sl]), t(bcols[sl]))
            pl, bpl = plan_of(cols[sl]), plan_of(bcols[sl])
            plans[lo] = (loc, pl)
            xs, bs = t(x[sl]), t(b)
            tag = f"P_local={P} [{lo}:{lo + P}] {sr.name}"
            compare(spmv_blocked_cuda(*loc, xs, sr, plan=pl),
                    spmv_blocked_ref(*loc, xs, sr), sr.name,
                    f"spmv local sweep {tag}")
            compare(spmv_blocked_cuda(*bnd, bs, sr, n_out_blocks=nvb,
                                      plan=bpl),
                    spmv_blocked_ref(*bnd, bs, sr, n_out_blocks=nvb),
                    sr.name, f"spmv consume {tag}")
            x3, b3 = xs.reshape(P, nvb, B), bs.reshape(1, nbb, B)
            if sr is MIN_PLUS:
                shapes = {"sweep": (loc, pl, x3, x3, x3),
                          "consume": (bnd, bpl, b3, x3,
                                      torch.flip(x3, (2,)).contiguous())}
            else:
                shapes = {"spmv": (loc, pl, x3, None, None),
                          "consume": (bnd, bpl, b3, None, None)}
            for name, (st, p_, xin, comb, xref) in shapes.items():
                m = None if xref is None else vm
                ko, kc = fused_step_cuda(*st, xin, comb, xref, m, sr,
                                         n_out_blocks=nvb, plan=p_)
                po, pc = fused_step_ref(*st, xin, comb, xref, m, sr,
                                        n_out_blocks=nvb)
                compare(ko, po, sr.name, f"fused {name} {tag}")
                need((kc is None and pc is None) or torch.equal(kc, pc),
                     f"fused {name} {tag}: votes differ")
            n += 4
        # the control: shard 0's tiles walked with shard 1's plan
        (loc, _), (_, other) = plans[0], plans[P]
        xs = t(x[:P])
        try:
            compare(spmv_blocked_cuda(*loc, xs, sr, plan=other),
                    spmv_blocked_ref(*loc, xs, sr), sr.name,
                    f"control: shard 0 with shard 1's plan {sr.name}")
        except SmokeFailure:
            n += 1
        else:
            raise SmokeFailure(f"wrong control passed: shard 0 walked "
                               f"with shard 1's plan ({sr.name})")
    return n


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(cfg, device="cuda", n_sparse=4, log=print):
    """Drive the port's TemporalEngine at ``cfg``.  Returns a dict of what
    phases 6 and 7 need (the in-memory results, one instance's staged
    tiles and states) and the per-run records."""
    import numpy as np
    import torch

    from repro_torch.core.algorithms import pagerank, sssp
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.engine import (
        TemporalEngine, min_plus_program, pagerank_program, source_init)
    from repro_torch.core.generator import generate_collection
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.semiring import INF

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    runs = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = {"seconds": time.perf_counter() - t0}
        if hasattr(out, "stats"):
            st = out.stats
            ss = int(st["supersteps"].sum())
            runs[name].update(
                supersteps=ss, local_sweeps=int(st["local_sweeps"].sum()),
                host_syncs=int(st["host_syncs"].sum()),
                host_syncs_per_superstep=(
                    int(st["host_syncs"].sum()) / ss if ss else 0.0))
        log(f"phase {name}: " + json.dumps(runs[name]))
        return out

    t0 = time.perf_counter()
    col = generate_collection(cfg)
    tmpl = col.template
    assign = partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
    bg = build_blocked(tmpl, assign, cfg.block_size)
    I, V = len(col), tmpl.num_vertices
    lat = np.stack([col.edge_values(t, sssp.WEIGHT_ATTR) for t in range(I)])
    act = np.stack([col.edge_values(t, pagerank.ACTIVE_ATTR)
                    for t in range(I)])
    prw = pagerank.edge_weights_for_instances(tmpl.src, act, V)
    log(f"phase setup: {json.dumps({'seconds': time.perf_counter() - t0, 'vertices': V, 'edges': tmpl.num_edges, 'instances': I, 'partitions': bg.n_parts, 'block': bg.block_size, 't_max': bg.t_max, 'tb_max': bg.tb_max, 'num_boundary': bg.num_boundary})}")

    sssp_prog = min_plus_program("sssp", init=source_init(0))
    pr_prog = pagerank_program(V, iters=10)
    eng = {m: TemporalEngine(bg, device=device, use_pallas=m)
           for m in ("spmv", "fused")}

    # --- SSSP, sequential, dense: spmv vs fused vs oracle ---------------
    tiles, btiles = timed("stage_sssp", lambda: eng["spmv"].stage(lat, INF))
    keep = {"sssp_tiles": tiles[0].clone(), "sssp_btiles": btiles[0].clone()}
    r_sp = timed("sssp_sequential_spmv", lambda: eng["spmv"].run(
        sssp_prog, pattern="sequential", tiles=tiles, btiles=btiles))
    r_fu = timed("sssp_sequential_fused", lambda: eng["fused"].run(
        sssp_prog, pattern="sequential", tiles=tiles, btiles=btiles))
    n_ev = I
    r_ev = timed("sssp_eventually_mean_fused", lambda: eng["fused"].run(
        sssp_prog, pattern="eventually", merge="mean",
        tiles=tiles[:n_ev], btiles=btiles[:n_ev]))
    # the query phase runs over the same staged batch, then drops it
    keep["staged_sssp"] = (tiles, btiles)
    del tiles, btiles
    eng_sparse = TemporalEngine(bg, device=device, use_pallas="spmv",
                                layout="sparse")
    n_sp = min(I, n_sparse)
    r_sparse = timed("sssp_sequential_sparse_spmv", lambda: eng_sparse.run(
        sssp_prog, lat[:n_sp], pattern="sequential"))
    log(f"sparse layout: {n_sp} instances, occupancy {r_sparse.occupancy}")

    # --- PageRank, independent, dense: spmv vs fused vs oracle ----------
    tiles, btiles = timed("stage_pagerank",
                          lambda: eng["spmv"].stage(prw, 0.0))
    keep.update(pr_tiles=tiles[0].clone(), pr_btiles=btiles[0].clone())
    p_sp = timed("pagerank_independent_spmv", lambda: eng["spmv"].run(
        pr_prog, pattern="independent", tiles=tiles, btiles=btiles))
    p_fu = timed("pagerank_independent_fused", lambda: eng["fused"].run(
        pr_prog, pattern="independent", tiles=tiles, btiles=btiles))
    del tiles, btiles
    if device == "cuda":
        torch.cuda.empty_cache()

    # --- checks ---------------------------------------------------------
    t0 = time.perf_counter()
    need(np.array_equal(r_sp.values, r_fu.values, equal_nan=True),
         "sssp: spmv and fused values differ")
    need(np.array_equal(r_sp.final, r_fu.final), "sssp: finals differ")
    for k in ("supersteps", "local_sweeps"):
        need(np.array_equal(r_sp.stats[k], r_fu.stats[k]),
             f"sssp: {k} differ between spmv and fused")
    ref = sssp.oracle(tmpl.src, tmpl.dst, lat, V, 0)
    fin = np.isfinite(ref)
    need(np.array_equal(np.isfinite(r_sp.final), fin),
         "sssp: reachability differs from the oracle")
    need(np.allclose(r_sp.final[fin], ref[fin], rtol=1e-5, atol=0),
         "sssp: distances differ from the oracle beyond rtol 1e-5")
    need(r_sp.final.shape == (V,) and r_sp.values.shape == (I, V),
         "sssp: result shapes")
    need(np.array_equal(r_ev.values[0], r_sp.values[0]),
         "eventually: instance 0 differs from the sequential run")
    with np.errstate(invalid="ignore"):
        mean = r_ev.values.mean(axis=0)
    need(np.allclose(r_ev.merged, mean, rtol=1e-6, atol=0, equal_nan=True),
         "eventually: merged is not the instance mean")
    need(np.array_equal(r_sparse.values, r_sp.values[:n_sp]),
         "sparse layout differs from dense")
    need(bool(np.isfinite(p_sp.values).all()), "pagerank: non-finite ranks")
    sp_t, fu_t = torch.from_numpy(p_sp.values), torch.from_numpy(p_fu.values)
    d = float((sp_t - fu_t).abs().max())
    d_used = float(((sp_t - fu_t).abs() / plus_mul_limit(sp_t)).max())
    need(d_used <= 1.0, f"pagerank: spmv vs fused differ by {d} "
                        f"({d_used:.3g}x the limit)")
    pr_err = pr_used = 0.0
    for t in range(I):
        o = torch.from_numpy(
            pagerank.oracle(tmpl.src, tmpl.dst, act[t], V, iters=10))
        lim = plus_mul_limit(o, ORACLE_TOL)
        for res in (p_sp, p_fu):
            e = (torch.from_numpy(res.values[t]).double() - o).abs()
            pr_err = max(pr_err, float(e.max()))
            pr_used = max(pr_used, float((e / lim).max()))
    need(pr_used <= 1.0, f"pagerank: oracle error {pr_err} ({pr_used:.3g}x "
                         f"the limit)")
    log(f"phase checks: {json.dumps({'seconds': time.perf_counter() - t0, 'pagerank_spmv_vs_fused': d, 'pagerank_spmv_vs_fused_limit_used': d_used, 'pagerank_vs_oracle': pr_err, 'pagerank_vs_oracle_limit_used': pr_used, 'pagerank_mean_rank': float(sp_t.mean()), 'sssp_reached': int(fin.sum())})}")

    # states for phase 7: the converged SSSP state and its boundary
    x_sssp = torch.as_tensor(
        bg.scatter_vertex(r_sp.final.astype(np.float32), INF), device=device)
    x_pr = torch.as_tensor(bg.scatter_vertex(p_sp.values[0], 0.0),
                           device=device)
    keep.update(bg=bg, x_sssp=x_sssp, x_pr=x_pr, eng=eng["spmv"],
                runs=runs, cut={"sparse_instances": n_sp,
                                "eventually_instances": n_ev})
    # what the GoFS path is held against: the collection, its in-memory
    # matrices, the engines, and their results
    keep["in_memory"] = dict(
        col=col, lat=lat, act=act, engines=eng, sssp_oracle=ref,
        sssp={"spmv": r_sp, "fused": r_fu}, sssp_eventually=r_ev,
        pagerank={"spmv": p_sp, "fused": p_fu})
    return keep


@contextlib.contextmanager
def call_shapes():
    """Count the graph kernels' launches by call shape while the block
    runs: yields a dict {(kernel, call): launches}, ``call`` named as in
    :func:`kernel_report` ("local sweep min_plus", "consume plus_mul",
    "sweep min_plus", "spmv plus_mul", ...; a Q-lane call of the query
    axis adds " Q=<lanes>", "local sweep min_plus Q=32").  It wraps the
    names through which the engine reaches the wrappers; the wrappers'
    own counts move as before, and the shapes' counts sum to them.  Blocks nest: an inner
    block counts its launches in the outer block's dict too."""
    from repro_torch.kernels.semiring_spmm import kernel as spmm_kernel
    from repro_torch.kernels.semiring_spmm import ops as spmm_ops
    from repro_torch.kernels.semiring_superstep import kernel as step_kernel
    from repro_torch.kernels.semiring_superstep import ops as step_ops

    counts = {}
    real_spmv, real_fused = spmm_ops.spmv_blocked_cuda, \
        step_ops.fused_step_cuda
    # the counts live on the wrappers themselves, whatever wraps them
    k_spmv, k_fused = spmm_kernel.spmv_blocked_cuda, \
        step_kernel.fused_step_cuda

    def add(kernel, call, before, after):
        key = (kernel, call)
        counts[key] = counts.get(key, 0) + after - before

    def lanes(x, rank):  # " Q=<lanes>" for a Q-lane call
        return f" Q={x.shape[0]}" if x.ndim == rank + 1 else ""

    def spmv(tiles, rows, cols, x, sr, **kw):
        n = k_spmv.launches
        out = real_spmv(tiles, rows, cols, x, sr, **kw)
        shape = "consume" if x.shape[-2] == 1 else "local sweep"
        add("spmv_blocked_cuda", f"{shape} {sr.name}{lanes(x, 2)}", n,
            k_spmv.launches)
        return out

    def fused(tiles, rows, cols, x_in, x_comb, *args, **kw):
        n = k_fused.launches
        out = real_fused(tiles, rows, cols, x_in, x_comb, *args, **kw)
        sr = args[2]
        shape = "consume" if x_in.shape[-3] == 1 else (
            "sweep" if x_comb is not None else "spmv")
        add("fused_step_cuda", f"{shape} {sr.name}{lanes(x_in, 3)}", n,
            k_fused.launches)
        return out

    spmm_ops.spmv_blocked_cuda, step_ops.fused_step_cuda = spmv, fused
    try:
        yield counts
    finally:
        spmm_ops.spmv_blocked_cuda = real_spmv
        step_ops.fused_step_cuda = real_fused


# ---------------------------------------------------------------------------
# phase 5b: the query axis on the main path
# ---------------------------------------------------------------------------

# sources of the query phase: the reference service's batch width
# (max_batch_queries, src/repro/gopher/service.py:202)
QUERY_LANES = 32


def query_sources(V, seed=0, lanes=QUERY_LANES):
    """The query phase's sources: lane 0 is vertex 0 (phase 5's source),
    the others drawn from ``seed``; and the lanes held against their own
    single-source runs by name: 0, the last, and two drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    srcs = [0] + [int(v) for v in rng.choice(np.arange(1, V), lanes - 1,
                                             replace=False)]
    drawn = rng.choice(np.arange(1, lanes - 1), 2, replace=False)
    return srcs, sorted({0, lanes - 1, *(int(q) for q in drawn)})


def query_phase(keep, device="cuda", log=print):
    """SSSP with QUERY_LANES sources as one engine pass over phase 5's
    staged TR_SMALL batch (48 instances, dense, sequential), in spmv and
    fused mode: every lane's values, final state and counts bitwise equal
    across the modes; every lane bitwise equal to its own single-source
    run (all 32 run alone over the same batch, spmv, and timed), lane 0
    also to phase 5's run; the spmv launches of the batched run equal its
    host syncs (one launch, then one vote read, per sweep and per
    consume), at least the slowest lanes' counts and far under the single
    runs' sum.  Returns the phase's records; ``keep["query"]`` gets the
    sources and the batched result (the session phase's reference)."""
    import numpy as np
    import torch

    from repro_torch.core.engine import (
        min_plus_program, source_init, sources_init)
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda

    mem, bg = keep["in_memory"], keep["bg"]
    tiles, btiles = keep.pop("staged_sssp")
    eng = mem["engines"]
    V, I = len(bg.part_of), int(tiles.shape[0])
    srcs, sampled = query_sources(V)
    Q = len(srcs)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def run(mode, prog):
        sync()
        n0 = (spmv_blocked_cuda.launches, fused_step_cuda.launches)
        t0 = time.perf_counter()
        r = eng[mode].run(prog, pattern="sequential", tiles=tiles,
                          btiles=btiles)
        sync()
        return r, time.perf_counter() - t0, (
            spmv_blocked_cuda.launches - n0[0],
            fused_step_cuda.launches - n0[1])

    recs = {"sources": srcs, "sampled_lanes": sampled, "lanes": Q,
            "instances": I}
    prog = min_plus_program("sssp", init=sources_init(srcs))
    batched = {}
    for mode in ("spmv", "fused"):
        r, wall, (n_sp, n_fu) = run(mode, prog)
        need(r.values.shape == (Q, I, V) and r.final.shape == (Q, V)
             and r.stats["supersteps"].shape == (Q, I),
             f"query ({mode}): result shapes")
        need(bool((r.final[np.arange(Q), srcs] == 0).all()),
             f"query ({mode}): a source is not at distance 0")
        batched[mode] = r
        per_lane = r.stats["supersteps"] + r.stats["local_sweeps"]
        recs[mode] = dict(
            seconds=wall, launches={"spmv_blocked_cuda": n_sp,
                                    "fused_step_cuda": n_fu},
            host_syncs=int(r.stats["host_syncs"].sum()),
            slowest_lane_launches=int(per_lane.max(0).sum()),
            sum_over_lanes_launches=int(per_lane.sum()),
            supersteps_per_lane_max=int(r.stats["supersteps"].max()),
            local_sweeps_per_lane_max=int(r.stats["local_sweeps"].max()))
        n = n_sp if mode == "spmv" else n_fu
        if device != "cuda":  # a CPU rehearsal launches nothing
            n = recs[mode]["host_syncs"]
        need(n == recs[mode]["host_syncs"],
             f"query ({mode}): {n} launches for "
             f"{recs[mode]['host_syncs']} vote reads (one launch a read "
             f"while no cap is reached)")
        need(recs[mode]["slowest_lane_launches"] <= n
             < recs[mode]["sum_over_lanes_launches"],
             f"query ({mode}): {n} launches, not between the slowest "
             f"lanes' {recs[mode]['slowest_lane_launches']} and the sum "
             f"{recs[mode]['sum_over_lanes_launches']}")
        need(r.stats["supersteps"].max() < 64, "query: superstep cap hit")
        log(f"phase query_{mode}: {json.dumps(recs[mode])}")
    a, b = batched["spmv"], batched["fused"]
    need(np.array_equal(a.values, b.values, equal_nan=True)
         and np.array_equal(a.final, b.final, equal_nan=True),
         "query: spmv and fused lanes differ")
    for k in ("supersteps", "local_sweeps"):
        need(np.array_equal(a.stats[k], b.stats[k]),
             f"query: {k} differ between spmv and fused")
    one0 = mem["sssp"]["spmv"]
    need(np.array_equal(a.values[0], one0.values, equal_nan=True)
         and np.array_equal(a.stats["supersteps"][0],
                            one0.stats["supersteps"]),
         "query: lane 0 differs from phase 5's source-0 run")

    # every lane alone over the same batch (spmv), timed
    single_s, single_launches = 0.0, 0
    for q, v in enumerate(srcs):
        r, wall, (n_sp, _) = run("spmv", min_plus_program(
            "sssp", init=source_init(v)))
        single_s += wall
        single_launches += n_sp
        for f in ("values", "final"):
            need(np.array_equal(getattr(a, f)[q], getattr(r, f),
                                equal_nan=True),
                 f"query: lane {q} (source {v}) {f} differ from its "
                 f"single-source run")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(a.stats[k][q], r.stats[k]),
                 f"query: lane {q} (source {v}) {k} differ from its "
                 f"single-source run")
    recs["single_source_runs"] = dict(
        runs=Q, seconds=single_s, spmv_launches=single_launches,
        measured="all 32 runs, none projected")
    recs["speedup_over_single_runs"] = {
        m: single_s / recs[m]["seconds"] for m in ("spmv", "fused")}
    log(f"phase query_single: {json.dumps(recs['single_source_runs'])}")
    log(f"phase query_checks: {json.dumps({'sampled_lanes': sampled, 'lanes_checked': Q, 'speedup_over_single_runs': recs['speedup_over_single_runs']})}")
    keep["query"] = {"sources": srcs, "result": a}
    del tiles, btiles
    if device == "cuda":
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 6d: the mesh (multi-GPU placement) on the one card
# ---------------------------------------------------------------------------

# the longest phase 6d waits on its ranks
MESH_WAIT = 900.0
MESH_COMMS = ("dense", "ring", "ring-rs")
# time packs of phase 6d's in-memory runs (TR_SMALL: 20 of the 48
# instances; the runs from the store stream all of them).  A depth cut
# taken when the smoke ran 1,104 s on one H100 with phase 6's delta-route
# session run and 6c's other-mode rerun restored; over all 48 the
# in-memory runs took about 75 of 6d's 194 s
MESH_MEMORY_PACKS = 1
# time packs of the runs from the store of phase 6d's (b) and (c) (a
# ``time_range`` prefix of the deployment): a depth cut taken when a
# smoke ran 1,227.7 s on one H100 whose host phases ran a third slower
# than before; over all 48 instances these two runs took 14-18 s each.
# (a), the NCCL run through the session, streams all 48 (14.0 s over
# all, 13.5 s over the first pack), so the mesh still streams across
# time-pack boundaries
MESH_STORE_PACKS = 1


def _mesh_inputs(cfg):
    """Phase 5's collection, rebuilt in a rank (0.8 s at TR_SMALL)."""
    import numpy as np

    from repro_torch.core.algorithms import pagerank, sssp
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.generator import generate_collection
    from repro_torch.core.partition import partition_graph

    col = generate_collection(cfg)
    tmpl = col.template
    bg = build_blocked(tmpl, partition_graph(tmpl, cfg.num_partitions,
                                             seed=cfg.seed), cfg.block_size)
    I, V = len(col), tmpl.num_vertices
    lat = np.stack([col.edge_values(t, sssp.WEIGHT_ATTR) for t in range(I)])
    act = np.stack([col.edge_values(t, pagerank.ACTIVE_ATTR)
                    for t in range(I)])
    return bg, tmpl, lat, act, pagerank.edge_weights_for_instances(
        tmpl.src, act, V)


@contextlib.contextmanager
def counted_fills(bg):
    """Sum the bytes of ``bg``'s dense tile fills while the block runs:
    yields a list that gets each fill's (instances, partitions, bytes)."""
    seen = []
    real = {k: getattr(bg, k) for k in ("fill_local_batch",
                                         "fill_boundary_batch")}

    def wrap(fn):
        def counted(w, *a, **k):
            out = fn(w, *a, **k)
            seen.append((int(out.shape[0]), int(out.shape[1]),
                         int(out.nbytes)))
            return out
        return counted

    for k, fn in real.items():
        setattr(bg, k, wrap(fn))
    try:
        yield seen
    finally:
        for k in real:
            delattr(bg, k)


def mesh_worker(spec) -> int:
    """One rank of phase 6d (``chip_smoke.py --mesh-worker SPEC``): joins
    the (data, model) mesh on the card with the spec's backend, runs its
    part's analytics on phase 5's TR_SMALL collection with the graph
    kernels' launches counted by call shape and by walk and the tile
    fills' bytes counted, and writes its record (rank 0 also its result
    arrays; every rank the digests of its results)."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from repro_torch.configs.goffish_tr import TR_SMALL, TR_TINY
    from repro_torch.core import comm as C
    from repro_torch.core.engine import (TemporalEngine, min_plus_program,
                                         pagerank_program, source_init,
                                         sources_init)
    from repro_torch.core.semiring import INF
    from repro_torch.core.temporal import pagerank_temporal
    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda
    from repro_torch.launch.mesh import init_mesh

    @dataclasses.dataclass(frozen=True)
    class SkipPeer(C.DenseAllReduce):
        """The wrong control: a combine that keeps this rank's partial
        and drops its peer's (the votes still cross)."""

        name: str = "skip-peer"

        def combine_boundary(self, buf, sr):
            return C._stack_fold(buf, sr)

    t_start = time.perf_counter()
    cuda = spec["device"] == "cuda"  # a CPU rehearsal: control flow only
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    rank, part = spec["rank"], spec["part"]
    bg, tmpl, lat, act, prw = _mesh_inputs(
        {c.name: c for c in (TR_SMALL, TR_TINY)}[spec["cfg"]])
    n = spec["instances"]  # the in-memory runs' first instances
    lat, act, prw = lat[:n], act[:n], prw[:n]
    V = tmpl.num_vertices
    mesh = init_mesh(spec["data"], spec["model"], backend=spec["backend"],
                     device=dev, init_method=spec["init"], rank=rank,
                     world_size=spec["data"] * spec["model"],
                     timeout=MESH_WAIT)
    kernels = (spmv_blocked_cuda, fused_step_cuda)
    for k in kernels:
        k.launches = 0
    arrays, runs, exchange = {}, {}, {}

    def keep(name, r, fields=("values", "final")):
        for f in fields:
            arrays[f"{name}/{f}"] = np.asarray(getattr(r, f))
        if r.stats is not None:
            for f in ("supersteps", "local_sweeps"):
                arrays[f"{name}/{f}"] = np.asarray(r.stats[f])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(name, fn):
        sync()
        C.reset_exchange_stats()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = time.perf_counter() - t0
        exchange[name] = C.exchange_stats()
        return out

    sssp = min_plus_program("sssp", init=source_init(0))
    control = None
    w0 = walk_counts()
    with PeakRSS() as rss, call_shapes() as shapes, \
            counted_fills(bg) as fills:
        def store_run(name, **knobs):
            """An SSSP through ``GopherSession(store, mesh=...)`` on phase
            6's deployment, its fills counted on the session's graph."""
            window = spec["store_window"]
            sess = GopherSession(GoFSStore(spec["store"], time_range=None
                                           if window is None
                                           else tuple(window)),
                                 mesh=mesh, device=dev)
            plan = sess.plan("sssp", source=0, **knobs)
            with counted_fills(sess.bg) as seen:
                keep(name, timed(name, lambda: sess.run(plan)).engine)
            stream_fills[name] = seen
            return plan

        stream_fills = {}
        if part == "nccl":
            explain = store_run("sssp").explain()
        elif part == "model":
            eng = {(c, m): TemporalEngine(bg, device=dev, mesh=mesh, comm=c,
                                          use_pallas=m)
                   for c in MESH_COMMS for m in ("spmv", "fused")}
            tiles, btiles = timed("stage_sssp", lambda: eng[
                "dense", "spmv"].stage(lat, INF))
            srcs = spec["sources"]
            for c in MESH_COMMS:
                for m in ("spmv", "fused"):
                    keep(f"sssp/{c}/{m}", timed(
                        f"sssp/{c}/{m}", lambda: eng[c, m].run(
                            sssp, tiles=tiles, btiles=btiles,
                            pattern="sequential")))
                keep(f"query/{c}", timed(f"query/{c}", lambda: eng[
                    c, "spmv"].run(min_plus_program(
                        "sssp", init=sources_init(srcs)), tiles=tiles,
                        btiles=btiles, pattern="sequential")))
            ctl = TemporalEngine(bg, device=dev, mesh=mesh,
                                 comm=SkipPeer(axis_name=("model",)))
            # the control's launches are counted apart from the path's
            c_w0 = walk_counts()
            c_n0 = {k.__name__: k.launches for k in kernels}
            with call_shapes() as c_shapes:
                keep("control", timed("control", lambda: ctl.run(
                    sssp, tiles=tiles, btiles=btiles,
                    pattern="sequential")))
            control = {
                "launches": {k.__name__: k.launches - c_n0[k.__name__]
                             for k in kernels},
                "launches_by_call_shape": {
                    f"{k} {c}": n for (k, c), n in c_shapes.items()},
                "launches_by_walk": check_walks(
                    f"mesh rank {rank} control", c_shapes, c_w0,
                    walk_counts())}
            del tiles, btiles
            if cuda:
                torch.cuda.empty_cache()
            tiles, btiles = timed("stage_pagerank", lambda: eng[
                "dense", "spmv"].stage(prw, 0.0))
            pr = pagerank_program(V, iters=10)
            for c in MESH_COMMS:
                keep(f"pagerank/{c}", timed(f"pagerank/{c}", lambda: eng[
                    c, "spmv"].run(pr, tiles=tiles, btiles=btiles,
                                   pattern="independent")),
                     fields=("values",))
            del tiles, btiles
            if cuda:
                torch.cuda.empty_cache()
            store_run("store_sssp", staging="async")
            explain = None
        else:  # "data": instances over two ranks
            ranks, merged = timed("pagerank_temporal", lambda:
                                  pagerank_temporal(
                                      bg, tmpl.src, act, mesh,
                                      num_vertices=V, iters=10, device=dev))
            arrays["temporal/values"] = ranks
            arrays["temporal/merged"] = merged
            ring = TemporalEngine(bg, device=dev, mesh=mesh, comm="ring")
            keep("sssp_independent_ring", timed(
                "sssp_independent_ring", lambda: ring.run(
                    sssp, lat, pattern="independent")))
            if cuda:
                torch.cuda.empty_cache()
            store_run("store_sssp_independent", staging="async",
                      pattern="independent")
            explain = None
        sync()
    def less(a, b):  # the path's launches: all of them less the control's
        return {k: n - b.get(k, 0) for k, n in a.items()}

    ctl = control or {"launches": {}, "launches_by_call_shape": {},
                      "launches_by_walk": {}}
    walks = check_walks(f"mesh rank {rank}", shapes, w0, walk_counts())
    rec = {
        "rank": rank, "part": part, "backend": spec["backend"],
        "card": torch.cuda.get_device_name(0) if cuda else None,
        "seconds": time.perf_counter() - t_start, "runs": runs,
        "exchange": exchange, "fills": fills,
        "staged_bytes": sum(b for _, _, b in fills),
        "stream_fills": stream_fills,
        "stream_staged_bytes": {k: sum(b for _, _, b in v)
                                for k, v in stream_fills.items()},
        "launches": less({k.__name__: k.launches for k in kernels},
                         ctl["launches"]),
        "launches_by_call_shape": less({
            f"{k} {c}": n for (k, c), n in sorted(shapes.items())},
            ctl["launches_by_call_shape"]),
        "launches_by_walk": {k: less(v, ctl["launches_by_walk"].get(k, {}))
                             for k, v in walks.items()},
        "control_launches": ctl["launches"],
        "host_peak_rss_gb": rss.peak_gb,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9
        if cuda else None,
        "digests": {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
                    .hexdigest() for k, v in sorted(arrays.items())},
        "explain": explain,
    }
    if rank == 0:
        np.savez(os.path.join(spec["out"], f"{part}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"{part}_{rank}.json"), "w") as f:
        json.dump(rec, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_mesh(part, data, model, backend, out, extra, log):
    """Start one mesh's ranks (a ``file://`` rendezvous in ``out``) and
    wait for them; returns their records and rank 0's arrays."""
    world = data * model
    base = dict(part=part, data=data, model=model, backend=backend,
                out=out, init=f"file://{os.path.join(out, part + '_rdv')}",
                **extra)
    # the ranks share the host's cores: torch's CPU threads split them
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // world)))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
         json.dumps(dict(base, rank=r))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            left = max(1.0, MESH_WAIT - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise SmokeFailure(f"mesh {part}: ranks outlived {MESH_WAIT} s")
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SmokeFailure(f"mesh {part}: rank {r} exited "
                               f"{p.returncode}:\n{text[-6000:]}")
    recs = []
    for r in range(world):
        with open(os.path.join(out, f"{part}_{r}.json")) as f:
            recs.append(json.load(f))
    for r in recs[1:]:
        need(r["digests"] == recs[0]["digests"],
             f"mesh {part}: rank {r['rank']}'s results differ from rank "
             f"0's (every rank returns the global result)")
    log(f"phase mesh_{part}: " + json.dumps({
        "wall_seconds": time.perf_counter() - t0,
        **{k: [r[k] for r in recs] for k in (
            "seconds", "runs", "staged_bytes", "stream_staged_bytes",
            "host_peak_rss_gb", "peak_device_gb", "launches",
            "control_launches")}}))
    return recs, np_load(os.path.join(out, f"{part}.npz"))


def np_load(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def mesh_phase(cfg, keep, card, root, device="cuda", log=print):
    """Phase 6d: multi-GPU placement on the one card, in rank processes
    (:func:`mesh_worker`), against phases 5 and 5b, on phase 6's
    deployment ``root`` of the same collection.

    The in-memory runs of (b) and (c) take the first MESH_MEMORY_PACKS
    time packs and their runs from the store the first MESH_STORE_PACKS
    (a ``time_range`` prefix of the deployment); each is held against the
    first instances of phases 5 and 5b.  (a) streams every instance.

    (a) NCCL at world size 1: a (1, 1) ``backend="nccl"`` mesh, SSSP
    through ``GopherSession(store, mesh=...)`` (the planner's streamed
    route), bitwise phase 5's; (b) ``model = 2``
    under gloo (NCCL refuses two ranks on one device), each rank on the
    card with 4 of the 8 partitions: sequential SSSP in spmv and fused
    mode and SSSP with phase 5b's 32 sources, bitwise phases 5 and 5b,
    and independent PageRank within :func:`plus_mul_limit` of phase 5's,
    under ``dense``, ``ring`` and ``ring-rs``, and SSSP streamed from
    the store, bitwise; a rank whose combine drops its peer's partial
    must fail phase 5's comparison (its launches are counted apart);
    (c) ``data = 2`` under gloo: ``pagerank_temporal`` (each rank half
    the instances), ranks and ``merged`` within
    :func:`plus_mul_limit` of phase 5's PageRank and its mean, and
    independent SSSP under the ring (its continuation synced over data)
    and streamed from the store, bitwise phase 5's eventually run.
    Every rank's results equal rank 0's (digests); each rank's dense
    fills, in memory and streamed, are exactly its share of the batch
    (its partitions, and its instances where the pass shards them); the
    exchange's bytes per superstep are printed beside
    ``boundary_exchange_bytes``'s.  Returns the phase's records
    (launches summed over ranks)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.dist.collectives import boundary_exchange_bytes

    cuda = device == "cuda"  # a CPU rehearsal checks control flow only
    on = {"cfg": cfg.name, "device": device}
    mem = keep["in_memory"]
    r_sp, p_sp = mem["sssp"]["spmv"], mem["pagerank"]["spmv"]
    qref = keep["query"]["result"]
    bg = keep["bg"]
    I = mem["lat"].shape[0]
    n_mem, _ = first_packs(root, MESH_MEMORY_PACKS)
    n_store, window = first_packs(root, MESH_STORE_PACKS)
    on["instances"] = n_mem
    on["store_window"] = None if n_store == I else list(window)
    full_bytes = I * bg.n_parts * (bg.t_max + bg.tb_max) \
        * bg.block_size ** 2 * 4
    mem_bytes = full_bytes // I * n_mem
    if device == "cuda":
        torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="mesh_smoke_")
    recs = {"cut": {k: n for k, n in (("in_memory_instances", n_mem),
                                      ("model_data_store_instances",
                                       n_store))
                    if n < I}}

    def same(got, want, what):
        same_bits(torch.as_tensor(np.asarray(got)),
                  torch.as_tensor(np.asarray(want)), what)

    def close(got, want, what):
        g = torch.as_tensor(np.asarray(got, np.float32))
        w = torch.as_tensor(np.asarray(want, np.float32))
        used = float(((g - w).abs() / plus_mul_limit(w)).max())
        need(used <= 1.0, f"{what}: {used:.3g}x plus_mul_limit")
        return used

    def shard_fills(ranks, name, instances, parts):
        """Each rank's streamed fills of run ``name``: its ``parts``
        partitions in every chunk, ``instances`` in all, and exactly that
        share of the batch's bytes."""
        for r in ranks:
            f = r["stream_fills"][name]
            need(f and {p for _, p, _ in f} == {parts}
                 # a local and a boundary fill a chunk
                 and sum(i for i, _, _ in f) == 2 * instances
                 and sum(b for _, _, b in f) * I * bg.n_parts
                 == full_bytes * instances * parts,
                 f"mesh {name}: rank {r['rank']} filled {f}, not "
                 f"{instances} instances of {parts} partitions")

    def same_run(a, name, want, n=None, lanes=False):
        sl = slice(None) if n is None else slice(0, n)
        same(a[f"{name}/values"], want.values[..., sl, :],
             f"mesh {name}: values")
        last = want.values[..., (n or want.values.shape[-2]) - 1, :]
        same(a[f"{name}/final"], last, f"mesh {name}: final")
        for k in ("supersteps", "local_sweeps"):
            same(a[f"{name}/{k}"], np.asarray(want.stats[k])[..., sl],
                 f"mesh {name}: {k}")

    try:
        # (a) NCCL at world size 1, from the store, every instance (the
        # one mesh run that streams across time-pack boundaries)
        on["store"] = root
        nccl, a = _spawn_mesh("nccl", 1, 1, "nccl" if cuda else "gloo",
                              out, dict(on, store_window=None), log)
        same_run(a, "sssp", r_sp)
        shard_fills(nccl, "sssp", I, bg.n_parts)
        log("mesh nccl plan:\n" + nccl[0]["explain"])
        need("placement = mesh{'data': 1, 'model': 1}" in nccl[0]["explain"],
             "mesh nccl: the plan's placement is not the (1, 1) mesh")
        need("staging   = async" in nccl[0]["explain"],
             "mesh nccl: the plan does not stream from the store")
        need(nccl[0]["exchange"]["sssp"]["ops"] > 0,
             "mesh nccl: no collective ran")

        # (b) partitions over model = 2
        srcs = keep["query"]["sources"]
        model, b = _spawn_mesh("model", 1, 2, "gloo", out,
                               dict(on, sources=srcs), log)
        same_run(b, "store_sssp", r_sp, n_store)
        shard_fills(model, "store_sssp", n_store, bg.n_parts // 2)
        per_superstep = {}
        for c in MESH_COMMS:
            for m in ("spmv", "fused"):
                same_run(b, f"sssp/{c}/{m}", r_sp, n_mem)
            same_run(b, f"query/{c}", qref, n_mem)
            close(b[f"pagerank/{c}/values"], p_sp.values[:n_mem],
                  f"mesh pagerank/{c}")
            ex = model[0]["exchange"][f"sssp/{c}/spmv"]
            per_superstep[c] = {
                "measured_bytes_sent": ex["combine_bytes_sent"]
                / max(1, ex["combines"]),
                "boundary_exchange_bytes": boundary_exchange_bytes(
                    bg.num_boundary, 2, c)["bytes_per_device"],
                "combines": ex["combines"], "ops": ex["ops"],
                "host_staged_bytes": ex["host_staged_bytes"]}
        try:
            same_run(b, "control", r_sp, n_mem)
            control_failed = False
        except SmokeFailure:
            control_failed = True
        need(control_failed, "mesh control: a combine that drops the "
                             "peer's partial passed phase 5's comparison")
        log(f"mesh exchange per superstep (sssp, per rank): "
            f"{json.dumps(per_superstep)}")
        log(f"mesh staged bytes per rank and batch: "
            f"{[r['staged_bytes'] // 2 for r in model]} of "
            f"{mem_bytes} (model = 2, {n_mem} instances)")
        for r in model:
            sizes = {(i, p) for i, p, _ in r["fills"]}
            need(sizes == {(n_mem, bg.n_parts // 2)},
                 f"mesh model rank {r['rank']} filled {sizes}")
            need(r["staged_bytes"] == mem_bytes,  # two batches of half
                 f"mesh model rank {r['rank']} staged {r['staged_bytes']} "
                 f"bytes, two half batches are {mem_bytes}")

        # (c) instances over data = 2
        data, c_ = _spawn_mesh("data", 2, 1, "gloo", out, on, log)
        used = close(c_["temporal/values"], p_sp.values[:n_mem],
                     "mesh pagerank_temporal: ranks")
        used_m = close(c_["temporal/merged"], p_sp.values[:n_mem].mean(0),
                       "mesh pagerank_temporal: merged")
        same_run(c_, "sssp_independent_ring", mem["sssp_eventually"],
                 n_mem)
        same_run(c_, "store_sssp_independent", mem["sssp_eventually"],
                 n_store)
        shard_fills(data, "store_sssp_independent", n_store // 2,
                    bg.n_parts)
        for r in data:
            sizes = {(i, p) for i, p, _ in r["fills"]}
            need(sizes == {(n_mem // 2, bg.n_parts)},
                 f"mesh data rank {r['rank']} filled {sizes}")
            need(r["staged_bytes"] == mem_bytes,
                 f"mesh data rank {r['rank']} staged {r['staged_bytes']}")
        log(f"mesh staged bytes per rank and batch: "
            f"{[r['staged_bytes'] // 2 for r in data]} of "
            f"{mem_bytes} (data = 2, {n_mem} instances)")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ranks = nccl + model + data
    control_launches = {k: sum(r["control_launches"].get(k, 0)
                               for r in ranks) for k in model[0]["launches"]}
    launches, by_shape = {}, {}
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for c, n in r["launches_by_call_shape"].items():
            by_shape[c] = by_shape.get(c, 0) + n
    for k, v in launches.items():
        need(sum(n for c, n in by_shape.items() if c.startswith(k + " "))
             == v, f"{k}: mesh launches by call shape do not sum to {v}")
        need(v > 0 or not cuda, f"{k} was not launched on the mesh path")
    recs.update(
        launches=launches, launches_by_call_shape=by_shape,
        launches_by_walk=[r["launches_by_walk"] for r in ranks],
        staged_bytes={p: [r["staged_bytes"] for r in rs] for p, rs in (
            ("nccl", nccl), ("model", model), ("data", data))},
        staged_bytes_full_batch=mem_bytes // 2,
        exchange_per_superstep=per_superstep,
        stream_staged_bytes={p: [r["stream_staged_bytes"] for r in rs]
                             for p, rs in (("nccl", nccl), ("model", model),
                                           ("data", data))},
        pagerank_temporal_limit_used=[used, used_m],
        control_failed=control_failed, control_launches=control_launches,
        card=card)
    log(f"mesh path cuts: {json.dumps(recs['cut'])} ({cfg.name}: {I} "
        f"instances)")
    log(f"mesh path launches: {json.dumps(launches)} (the control's, "
        f"not among them: {json.dumps(control_launches)})")
    log(f"mesh path launches by call shape: {json.dumps(by_shape)}")
    return recs


def examples_phase(device="cuda", log=print):
    """The four examples' ``main(device=...)`` in this process, at their
    own sizes, asserts live; each one's seconds and the kernels' launches
    (graph kernels by call shape, attention by route)."""
    from repro_torch.examples import (quickstart, serve_lm, temporal_sssp,
                                      train_lm, vehicle_tracking)
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda

    graph = (spmv_blocked_cuda, fused_step_cuda)
    recs = {}
    for mod in (quickstart, temporal_sssp, vehicle_tracking, serve_lm,
                train_lm):
        name = mod.__name__.rsplit(".", 1)[-1]
        for k in graph:
            k.launches = 0
        reset_attn_launches()
        t0 = time.perf_counter()
        with call_shapes() as shapes:
            mod.main(device=device)
        flash, decode = attn_counters()
        attn = (flash, decode, flash_attention_bwd_cuda)
        recs[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": {k.__name__: k.launches for k in graph + attn},
            "attention_routes": {k.__name__: dict(k.launches_by_route)
                                 for k in attn},
            "launches_by_call_shape": {f"{k} {c}": n for (k, c), n in
                                       sorted(shapes.items())}}
        log(f"phase examples_{name}: {json.dumps(recs[name])}")
    for name, k in (("quickstart", "spmv_blocked_cuda"),
                    ("serve_lm", "flash_attention_cuda"),
                    ("serve_lm", "decode_attention_cuda"),
                    ("train_lm", "flash_attention_cuda"),
                    ("train_lm", "flash_attention_bwd_cuda")):
        need(recs[name]["launches"][k] > 0 or device != "cuda",
             f"examples: {name} did not launch {k}")
    bwd = recs["train_lm"]["attention_routes"]["flash_attention_bwd_cuda"]
    need(bwd.get("bf16_wgmma", 0) ==
         recs["train_lm"]["launches"]["flash_attention_bwd_cuda"],
         f"examples: train_lm's backward launches took the routes {bwd}, "
         f"not all bf16_wgmma")
    return recs


# ---------------------------------------------------------------------------
# phase 6: the graph path from a GoFS deployment
# ---------------------------------------------------------------------------

def host_rss_gb():
    """(current, peak) resident memory of this process in GB."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    with open("/proc/self/status") as f:
        cur = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return cur * 1024 / 1e9, peak


def check_upload(what, t, dtype):
    """A batch uploaded from the store is what the graph kernels read with
    16-byte loads: contiguous, of the kernels' dtype, its base and every
    outer stride 16-byte aligned."""
    need(t.dtype == dtype, f"{what}: dtype {t.dtype}, want {dtype}")
    need(t.is_contiguous(), f"{what}: not contiguous")
    need(t.data_ptr() % 16 == 0, f"{what}: base not 16-byte aligned")
    es = t.element_size()
    need(all(st * es % 16 == 0 for st, n in zip(t.stride()[:-1],
                                                 t.shape[:-1]) if n > 1),
         f"{what}: strides {t.stride()} x {es} bytes not 16-byte aligned")


# time packs of phase 6's host iBSP SSSP (TR_SMALL: 20 of the 48
# instances).  The smoke's first cut against its time limit: over all 48
# the host run took 69-100 s of a 1,013 s smoke
HOST_IBSP_PACKS = 1
# time packs of phase 6's sparse loads (delta chain and full slices, each
# pack reading the chain's whole payload pool): TR_SMALL's first 20 of 48
# instances, a depth cut taken when over all 3 packs they took 137 s of a
# 1,113 s smoke on one H100
SPARSE_LOAD_PACKS = 1
# time packs of the session's run of the streamed delta route (sparse
# override, fused; 70-85 s over all 3 packs, a whole pool read per pack)
SESSION_DELTA_PACKS = 1
# time packs of each cluster worker's SSSP in the kernel mode its auto
# plans did not pick (phase 6c's third pass; about 15 s over all 3)
CLUSTER_OTHER_MODE_PACKS = 1


def first_packs(root, packs):
    """(instances, time range) of the first ``packs`` time packs of the
    deployment at ``root``: a ``GoFSStore(time_range=...)`` prefix, over
    which a sequential run equals the whole run's first instances."""
    from repro_torch.gofs import GoFSStore

    meta = GoFSStore(root).meta
    ts = meta["timestamps"]
    n = min(len(ts), packs * int(meta["instances_per_slice"]))
    return n, (float(ts[0]), float(ts[n - 1]) + 1.0)


def same_prefix(got, whole, n, what):
    """``got``, a sequential run over the first ``n`` instances, bitwise
    equal to ``whole``'s first ``n`` (values, counts) and its ``final`` to
    ``whole``'s instance ``n - 1``.  ``got``/``whole``: dicts of
    ``values``, ``final``, ``supersteps`` and, where kept,
    ``local_sweeps``."""
    import numpy as np

    need(len(got["values"]) == n, f"{what}: {len(got['values'])} "
                                  f"instances, not {n}")
    need(np.array_equal(got["values"], whole["values"][:n], equal_nan=True),
         f"{what}: values differ from the whole run's first {n}")
    need(np.array_equal(got["final"], whole["values"][n - 1],
                        equal_nan=True),
         f"{what}: final differs from the whole run's instance {n - 1}")
    for k in ("supersteps", "local_sweeps"):
        if k in got:
            need(np.array_equal(got[k], whole[k][..., :n]),
                 f"{what}: {k} differ from the whole run's first {n}")


def gofs_path(cfg, keep, device="cuda", log=print, card=None):
    """Drive the graph path from a GoFS deployment of the collection the
    in-memory path ran (``keep["in_memory"]``), and hold every result
    against that path's.  Returns the phase's records."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.algorithms import pagerank, sssp
    from repro_torch.core.engine import (
        TemporalEngine, min_plus_program, pagerank_program, source_init)
    from repro_torch.gofs import GoFSStore, deploy_collection
    from repro_torch.gofs.layout import tile_map_name
    from repro_torch.gofs.slices import read_array_slice
    from repro_torch.core.semiring import INF

    mem, bg = keep["in_memory"], keep["bg"]
    col, lat, act, eng = mem["col"], mem["lat"], mem["act"], mem["engines"]
    tmpl = col.template
    I, V = len(col), tmpl.num_vertices
    recs = {"cut": {}}  # nothing of the configuration is cut

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def report(name, **kw):
        cur, peak = host_rss_gb()
        recs[name] = dict(kw, host_rss_gb=cur, host_peak_rss_gb=peak)
        log(f"phase gofs_{name}: {json.dumps(recs[name])}")

    def same_run(got, want, what):
        need(np.array_equal(got.values, want.values, equal_nan=True),
             f"{what}: values differ from the in-memory run")
        need(np.array_equal(got.final, want.final, equal_nan=True),
             f"{what}: final differs from the in-memory run")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(got.stats[k], want.stats[k]),
                 f"{what}: {k} differ from the in-memory run")

    root = tempfile.mkdtemp(prefix="gofs_smoke_")
    try:
        # 1. deploy, with latency tile maps and the delta chain
        t0 = time.perf_counter()
        meta = deploy_collection(col, cfg, root,
                                 sparse_absent={"latency": INF})
        deploy_s = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, fs in os.walk(root)
                 for f in fs]
        tm = read_array_slice(os.path.join(root, tile_map_name("latency")))
        report("deploy", seconds=deploy_s, slices=len(files),
               bytes_on_disk=sum(os.path.getsize(f) for f in files),
               instances=meta["num_instances"],
               partitions=meta["num_partitions"],
               instances_per_slice=meta["instances_per_slice"],
               bins_per_partition=meta["bins_per_partition"],
               occupancy=float(tm["occupancy"]),
               delta_unique_ratio=float(tm["delta_unique_ratio"]),
               delta_monotone=int(tm["delta_monotone"]))

        # 2. host iBSP SSSP on the store (the quickstart's step 3), over
        # the first HOST_IBSP_PACKS time packs (a time_range prefix: the
        # smoke's first cut against its time limit)
        ts = np.asarray(meta["timestamps"])
        n_host = min(I, HOST_IBSP_PACKS * int(meta["instances_per_slice"]))
        if n_host < I:
            recs["cut"]["host_ibsp_instances"] = n_host
        store = GoFSStore(root, vertex_projection=(),
                          edge_projection=("latency", "active"),
                          time_range=(float(ts[0]),
                                      float(ts[n_host - 1]) + 1.0))
        need(store.num_timesteps() == n_host, "host iBSP: time filter")
        t0 = time.perf_counter()
        dists, res = sssp.run_host(store, 0)
        host_s = time.perf_counter() - t0
        d_host = np.full(V, INF)
        for g, d in dists.items():
            d_host[store.get_topology(g).vertices] = d
        ref = mem["sssp_oracle"] if n_host == I else sssp.oracle(
            tmpl.src, tmpl.dst, lat[:n_host], V, 0)
        fin = np.isfinite(ref)
        need(np.array_equal(np.isfinite(d_host), fin),
             "host sssp on GoFS: reachability differs from the oracle")
        need(np.allclose(d_host[fin], ref[fin], rtol=1e-6, atol=0),
             "host sssp on GoFS: distances differ from the oracle beyond "
             "rtol 1e-6")
        cache = store.cache.stats()
        report("host_sssp", seconds=host_s, instances=store.num_timesteps(),
               subgraphs=len(store.subgraph_ids()),
               supersteps=res.stats.supersteps,
               compute_calls=res.stats.compute_calls,
               messages=res.stats.superstep_messages,
               slices_read=store.stats.slices_read,
               bytes_read=store.stats.bytes_read,
               cache_hit_rate=cache["hit_rate"], reached=int(fin.sum()))
        del store, dists

        # 3. dense load into the card (the quickstart's step 5)
        t0 = time.perf_counter()
        tiles, btiles = GoFSStore(root).load_blocked(bg, "latency")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(I):  # one instance's fill at a time
            w = lat[i:i + 1]
            need(np.array_equal(tiles[i], bg.fill_local_batch(w, INF)[0])
                 and np.array_equal(btiles[i],
                                    bg.fill_boundary_batch(w, INF)[0]),
                 f"dense load: instance {i} differs from the in-memory fill")
        check_s = time.perf_counter() - t0
        host_bytes = tiles.nbytes + btiles.nbytes
        sync()
        t0 = time.perf_counter()
        tiles_d = torch.as_tensor(tiles, device=device)
        btiles_d = torch.as_tensor(btiles, device=device)
        sync()
        upload_s = time.perf_counter() - t0
        del tiles, btiles
        check_upload("dense tiles", tiles_d, torch.float32)
        check_upload("dense btiles", btiles_d, torch.float32)
        prog = min_plus_program("sssp", init=source_init(0))
        runs = {}
        for mode in ("spmv", "fused"):
            sync()
            t0 = time.perf_counter()
            r = eng[mode].run(prog, pattern="sequential", tiles=tiles_d,
                              btiles=btiles_d)
            sync()
            runs[mode] = time.perf_counter() - t0
            same_run(r, mem["sssp"][mode], f"sssp from the dense load "
                                           f"({mode})")
            if mode == "spmv":
                dense_store_run = r
        report("dense_load", load_seconds=load_s, check_seconds=check_s,
               upload_seconds=upload_s, host_bytes=host_bytes,
               sssp_seconds=runs,
               supersteps=int(dense_store_run.stats["supersteps"].sum()),
               local_sweeps=int(dense_store_run.stats["local_sweeps"]
                                .sum()))
        del tiles_d, btiles_d
        if device == "cuda":
            torch.cuda.empty_cache()

        # 4. sparse loads, from the delta chain and from the full value
        # slices, one time pack at a time (host memory); sequential SSSP
        # on the delta batches carries its state across the packs
        eng_sp = TemporalEngine(bg, device=device, use_pallas="spmv",
                                layout="sparse")
        ipack = int(meta["instances_per_slice"])
        ts = np.asarray(meta["timestamps"])
        tot = dict(staged_bytes=0, source_bytes=0, pool_read_seconds=0.0,
                   delta_seconds=0.0, full_seconds=0.0, sssp_seconds=0.0,
                   active_tiles=0, template_tiles=0)
        x0, values, counts = None, [], []
        n_packs = min(-(-I // ipack), SPARSE_LOAD_PACKS)
        n_sp = min(I, n_packs * ipack)
        if n_sp < I:
            recs["cut"]["sparse_load_instances"] = n_sp
        for k in range(n_packs):
            lo, hi = k * ipack, min((k + 1) * ipack, I)
            window = (float(ts[lo]), float(ts[hi - 1]) + 1.0)
            t0 = time.perf_counter()
            st = GoFSStore(root, time_range=window)
            need(st.num_timesteps() == hi - lo, f"pack {k}: time filter")
            # the chain's slice, read whole and pinned; then the gather
            need(st.edge_delta_index("latency") is not None,
                 f"pack {k}: no delta chain")
            tot["pool_read_seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            sp_d = st.load_blocked(bg, "latency", layout="sparse")
            tot["delta_seconds"] += time.perf_counter() - t0
            del st  # drops the pinned payload pool
            need(sp_d.source_bytes is not None,
                 f"pack {k}: the delta route was not taken")
            sync()
            t0 = time.perf_counter()
            r = eng_sp.run(prog, pattern="sequential", sparse=sp_d, x0=x0)
            sync()
            tot["sssp_seconds"] += time.perf_counter() - t0
            up = eng_sp._cached_device((sp_d.tiles, sp_d.btiles, sp_d.rows,
                                        sp_d.cols, sp_d.brows, sp_d.bcols))
            for what, t_, dt in zip(
                    ("tiles", "btiles", "rows", "cols", "brows", "bcols"),
                    up[:6], (torch.float32,) * 2 + (torch.int32,) * 4):
                check_upload(f"delta {what}", t_, dt)
            del up
            values.append(r.values)
            counts.append([r.stats["supersteps"], r.stats["local_sweeps"]])
            x0 = bg.scatter_vertex(r.final, INF)
            t0 = time.perf_counter()
            sp_f = GoFSStore(root, time_range=window).load_blocked(
                bg, "latency", layout="sparse", delta=False)
            tot["full_seconds"] += time.perf_counter() - t0
            need(sp_f.source_bytes is None,
                 f"pack {k}: delta=False took the delta route")
            for f in ("tiles", "btiles", "rows", "cols", "brows", "bcols",
                      "nnz", "bnnz"):
                a, b = getattr(sp_d, f), getattr(sp_f, f)
                need(a.dtype == b.dtype and a.shape == b.shape
                     and all(np.array_equal(a[i], b[i])
                             for i in range(len(a))),
                     f"pack {k}: delta and full loads differ in {f}")
            tot["staged_bytes"] += sp_d.staged_bytes()
            tot["source_bytes"] += sp_d.source_bytes
            tot["active_tiles"] += int(sp_d.nnz.sum() + sp_d.bnnz.sum())
            tot["template_tiles"] += (hi - lo) * (sp_d.total_tiles
                                                  + sp_d.total_btiles)
            del sp_d, sp_f
        need(np.array_equal(np.concatenate(values),
                            dense_store_run.values[:n_sp], equal_nan=True),
             "sssp from the delta batches differs from the dense store run")
        for j, k in enumerate(("supersteps", "local_sweeps")):
            need(np.array_equal(np.concatenate([c[j] for c in counts]),
                                dense_store_run.stats[k][:n_sp]),
                 f"sssp from the delta batches: {k} differ from the dense "
                 f"store run")
        del eng_sp
        if device == "cuda":
            torch.cuda.empty_cache()
        report("sparse_load", packs=n_packs, instances=n_sp, **tot,
               occupancy=tot["active_tiles"] / max(1, tot["template_tiles"]),
               source_over_staged=tot["source_bytes"] / tot["staged_bytes"])

        # 5. PageRank from the store's activity
        t0 = time.perf_counter()
        a_store = GoFSStore(root).edge_attr_matrix(pagerank.ACTIVE_ATTR)
        need(np.array_equal(a_store, act), "active: store != in-memory")
        w = pagerank.edge_weights_for_instances(tmpl.src, a_store, V)
        tiles_d, btiles_d = eng["spmv"].stage(w, 0.0)
        sync()
        stage_s = time.perf_counter() - t0
        pr = pagerank_program(V, iters=10)
        used, store_pr = {}, {}
        for mode in ("spmv", "fused"):
            r = eng[mode].run(pr, pattern="independent", tiles=tiles_d,
                              btiles=btiles_d)
            store_pr[mode] = r
            need(bool(np.isfinite(r.values).all()),
                 f"pagerank from GoFS ({mode}): non-finite ranks")
            want = torch.from_numpy(mem["pagerank"][mode].values)
            err = (torch.from_numpy(r.values) - want).abs()
            used[mode] = float((err / plus_mul_limit(want)).max())
            need(used[mode] <= 1.0, f"pagerank from GoFS ({mode}): "
                                    f"{used[mode]:.3g}x the limit from the "
                                    f"in-memory run")
        del tiles_d, btiles_d
        if device == "cuda":
            torch.cuda.empty_cache()
        report("pagerank", stage_seconds=stage_s, limit_used=used)

        # 6. the Gopher session on the same deployment
        keep["session_held"] = {}
        for name, packs in (("session_delta_route_instances",
                             SESSION_DELTA_PACKS),
                            ("cluster_other_mode_instances",
                             CLUSTER_OTHER_MODE_PACKS)):
            n_cut = min(I, packs * ipack)
            if n_cut < I:
                recs["cut"][name] = n_cut
        recs["session"] = session_phase(
            root, tmpl, want={"spmv": dense_store_run,
                              "fused": mem["sssp"]["fused"],
                              "pagerank": store_pr["spmv"],
                              "query": keep["query"]},
            device=device, log=log, held=keep["session_held"])

        # 6c. the cluster runtime on the same deployment
        recs["cluster"] = cluster_phase(root, cfg, keep["session_held"],
                                        device=device, log=log)

        # 6d. the mesh on the same deployment, in rank processes
        t0 = time.perf_counter()
        recs["mesh"] = mesh_phase(cfg, keep, card, root, device=device,
                                  log=log)
        log(f"phase mesh: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return recs


class PeakRSS:
    """Sample this process's resident memory on a thread while the block
    runs; ``peak_gb`` is the largest reading."""

    def __enter__(self):
        import threading

        self.peak_gb = host_rss_gb()[0]
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.wait(0.1):
            self.peak_gb = max(self.peak_gb, host_rss_gb()[0])

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak_gb = max(self.peak_gb, host_rss_gb()[0])


def session_phase(root, tmpl, want, device="cuda", log=print, held=None):
    """The Gopher session on the GoFS deployment at full width and depth
    (``GopherSession(store).plan/run/run_many``), held against phase 6's
    explicit engine runs in ``want``: SSSP bitwise in both kernel modes
    and on the streamed delta route (over the first SESSION_DELTA_PACKS
    time packs, against step 1's first instances), PageRank within
    :func:`plus_mul_limit`, N-hop's histograms equal to the oracle's.
    Then the query axis through the session: SSSP with the query phase's
    32 sources streamed from the store, every lane bitwise equal to the
    query phase's in-memory lanes (``want["query"]``) and lane 0 to step
    1; N-hop with 4 sources, lane 0 equal to step 3's single-source
    histograms and the others to ``nhop.oracle`` on the first and last
    instance; ``tracking`` of the plate seen in the most timesteps, its
    trace equal to the host iBSP ``tracking.run_host`` on the store.
    The graph kernels' launches on this path are counted by call shape on
    their own.  ``held`` (a dict) receives what the stream phase is held
    against: step 1's SSSP result and step 6's N-hop histograms.  Returns
    the phase's records."""
    import numpy as np
    import torch

    from repro_torch.core.algorithms import nhop, tracking
    from repro_torch.gofs import GoFSStore
    from repro_torch.gofs.prefetch import pinned_ring, release_pinned
    from repro_torch.gopher import GopherSession
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda

    cuda = device == "cuda"  # a CPU rehearsal checks control flow only
    kernels = (spmv_blocked_cuda, fused_step_cuda)
    outer = [k.launches for k in kernels]
    for k in kernels:
        k.launches = 0
    recs = {}
    if cuda:
        free, total = torch.cuda.mem_get_info()
        recs.update(device_free_gb_before=free / 1e9,
                    device_total_gb=total / 1e9)
    log(f"phase session_setup: {json.dumps(recs)}")

    def same(got, ref, what):
        need(np.array_equal(got.values, ref.values, equal_nan=True),
             f"session {what}: values differ from phase 6")
        need(np.array_equal(got.final, ref.final, equal_nan=True),
             f"session {what}: final differs from phase 6")
        for k in ("supersteps", "local_sweeps"):
            need(np.array_equal(got.stats[k], ref.stats[k]),
                 f"session {what}: {k} differ from phase 6")

    def step(name, sess, fn):
        """Run ``fn`` with the session's engines' stream reports and the
        peaks fresh (the pinned ring keeps its buffers from step to step,
        as across any two passes); log and return its records."""
        if cuda:
            ring = pinned_ring(device)
            ring.peak_bytes, ring.pin_seconds = ring.pinned_bytes, 0.0
            torch.cuda.reset_peak_memory_stats()
        for e in sess._engines.values():
            e.last_stream_report = None
        t0 = time.perf_counter()
        with PeakRSS() as rss:
            out = fn()
        wall = time.perf_counter() - t0
        rec = dict(seconds=wall, report=dict(sess.last_run_report),
                   stream={"/".join(k): e.last_stream_report
                           for k, e in sess._engines.items()
                           if e.last_stream_report is not None},
                   host_peak_rss_gb=rss.peak_gb)
        if cuda:
            rec.update(peak_pinned_bytes=ring.peak_bytes,
                       pin_seconds=ring.pin_seconds,
                       peak_device_gb=torch.cuda.max_memory_allocated()
                       / 1e9)
        recs[name] = rec
        log(f"phase session_{name}: {json.dumps(rec)}")
        return out

    V, I = tmpl.num_vertices, len(want["spmv"].values)
    try:
        with call_shapes() as shapes:
            t0 = time.perf_counter()
            sess = GopherSession(GoFSStore(root), device=device)
            recs["open_seconds"] = time.perf_counter() - t0

            # 1. the auto plan: dense, dense comm, async, no delta, cold
            plan = sess.plan("sssp", source=0)
            got = {k: getattr(plan, k).value for k in (
                "layout", "comm", "staging", "delta", "warm", "kernel",
                "placement")}
            recs["plan"] = dict(got, occupancy=plan.estimate_dict[
                "occupancy"])
            need(not cuda or recs["plan"] == {
                "layout": "dense", "comm": "dense", "staging": "async",
                "delta": False, "warm": False, "kernel": "spmv",
                "placement": "stacked", "occupancy": 1.0},
                f"session plan: {recs['plan']}")
            log("session plan:\n" + plan.explain())
            r1 = step("sssp_spmv", sess, lambda: sess.run(plan))
            same(r1.engine, want["spmv"], "sssp (spmv)")

            # 2. the same plan in fused mode
            plan_f = sess.plan("sssp", source=0, kernel="fused")
            r2 = step("sssp_fused", sess, lambda: sess.run(plan_f))
            same(r2.engine, want["fused"], "sssp (fused)")

            # 3. three analytics in one run_many
            plans = [plan, sess.plan("nhop", source=0, n_hops=4),
                     sess.plan("pagerank", iters=10)]
            many = step("run_many", sess, lambda: sess.run_many(plans))
            same(many[0].engine, r1.engine, "run_many sssp")
            ranks = torch.from_numpy(many[2].output["ranks"])
            ref = torch.from_numpy(want["pagerank"].values)
            need(bool(torch.isfinite(ranks).all()),
                 "session pagerank: non-finite ranks")
            used = float(((ranks - ref).abs() / plus_mul_limit(ref)).max())
            need(used <= 1.0, f"session pagerank: {used:.3g}x the limit "
                              f"from phase 6's store PageRank")
            t0 = time.perf_counter()
            lat = GoFSStore(root).edge_attr_matrix("latency")
            hists = many[1].output["histograms"]
            need(hists.shape[0] == I, "session nhop: histogram count")
            for i in range(I):
                need(np.array_equal(hists[i], nhop.oracle(
                    tmpl.src, tmpl.dst, lat[i], V, 0, n_hops=4)),
                    f"session nhop: instance {i}'s histogram differs "
                    f"from nhop.oracle")
            checks = dict(
                open_seconds=recs["open_seconds"],
                pagerank_limit_used=used,
                nhop_composite=[int(x) for x in many[1].output["composite"]],
                nhop_oracle_seconds=time.perf_counter() - t0)
            recs["run_many"].update(checks)
            log(f"phase session_checks: {json.dumps(checks)}")
            nhop0 = many[1].output["histograms"]
            if held is not None:
                held.update(pagerank=many[2].engine,
                            staged_bytes=recs["sssp_spmv"]["report"][
                                "staged_bytes"])
            del many, sess
            if cuda:
                torch.cuda.empty_cache()

            # 4. the sparse override: the streamed delta route, fused, over
            # the first SESSION_DELTA_PACKS time packs (a time_range prefix)
            n_d, window = first_packs(root, SESSION_DELTA_PACKS)
            sess = GopherSession(GoFSStore(root, time_range=window),
                                 device=device)
            plan_d = sess.plan("sssp", source=0, layout="sparse",
                               kernel="fused")
            need(not cuda or (plan_d.delta.value is True
                              and plan_d.staging.value == "async"),
                 "session sparse plan: not the streamed delta route")
            r4 = step("sssp_delta_fused", sess, lambda: sess.run(plan_d))

            def run_dict(e):
                return dict(values=e.values, final=e.final, **{
                    k: e.stats[k] for k in ("supersteps", "local_sweeps")})

            same_prefix(run_dict(r4.engine), run_dict(r1.engine), n_d,
                        "session sssp (sparse delta, fused)")
            st = recs["sssp_delta_fused"]
            up = sum(v["uploaded_bytes"] for v in st["stream"].values())
            st.update(instances=n_d,
                      source_bytes=st["report"]["staged_bytes"],
                      staged_bytes=up, occupancy=r4.engine.occupancy)
            log(f"phase session_delta_bytes: {n_d} instances, source "
                f"{st['source_bytes']} staged {up}")
            del sess
            if cuda:
                torch.cuda.empty_cache()

            # 5. the query axis: SSSP with 32 sources, streamed
            sess = GopherSession(GoFSStore(root), device=device)
            srcs, qref = want["query"]["sources"], want["query"]["result"]
            plan_q = sess.plan("sssp", source=srcs)
            need(plan_q.estimate_dict["n_sources"] == len(srcs),
                 "session query plan: n_sources")
            need(not cuda or plan_q.staging.value == "async",
                 "session query plan: not streamed")
            r5 = step("sssp_q32", sess, lambda: sess.run(plan_q))
            need(r5.output["final"].shape == (len(srcs), V),
                 "session sssp (32 sources): final shape")
            same(r5.engine, qref, "sssp (32 sources)")
            for f in ("values", "final"):
                need(np.array_equal(getattr(r5.engine, f)[0],
                                    getattr(r1.engine, f), equal_nan=True),
                     f"session sssp (32 sources): lane 0 {f} differ from "
                     f"step 1")

            # 6. N-hop with 4 sources
            n_src = srcs[:4]
            r6 = step("nhop_q4", sess, lambda: sess.run(sess.plan(
                "nhop", source=n_src, n_hops=4)))
            hq = r6.output["histograms"]
            need(hq.shape[:2] == (4, I), "session nhop (4 sources): shape")
            need(np.array_equal(hq[0], nhop0),
                 "session nhop (4 sources): lane 0 differs from step 3")
            t0 = time.perf_counter()
            for q in range(1, 4):
                for i in (0, I - 1):
                    need(np.array_equal(hq[q, i], nhop.oracle(
                        tmpl.src, tmpl.dst, lat[i], V, n_src[q],
                        n_hops=4)),
                        f"session nhop: lane {q} instance {i} differs "
                        f"from nhop.oracle")
            recs["nhop_q4"]["oracle_seconds"] = time.perf_counter() - t0
            if held is not None:
                held.update(sssp=r1.engine, nhop_q4=hq)

            # 7. tracking of one plate, against host iBSP on the store
            plates = GoFSStore(root).vertex_attr_matrix(
                tracking.PLATE_ATTR)
            ids, seen = np.unique(
                [p for t in range(I) for p in np.unique(plates[t])
                 if p >= 0], return_counts=True)
            plate = int(ids[np.argmax(seen)])
            start = int(np.argwhere(plates == plate)[0][1])
            r7 = step("tracking", sess, lambda: sess.run(sess.plan(
                "tracking", plate=plate, initial_vertex=start)))
            t0 = time.perf_counter()
            host_trace, hres = tracking.run_host(
                GoFSStore(root, vertex_projection=(tracking.PLATE_ATTR,),
                          edge_projection=()), plate, start)
            host_s = time.perf_counter() - t0
            trace = r7.output["trace"]
            need(trace == host_trace,
                 f"session tracking: trace differs from host iBSP "
                 f"({len(trace)} vs {len(host_trace)} sightings)")
            need(len(trace) > 1, "session tracking: no trail to follow")
            recs["tracking"].update(
                plate=plate, initial_vertex=start, sightings=len(trace),
                timesteps_seen=int(seen.max()),
                host_ibsp_seconds=host_s,
                host_ibsp_compute_calls=hres.stats.compute_calls,
                host_ibsp_supersteps=hres.stats.supersteps)
            log(f"phase session_tracking_check: plate {plate} from "
                f"{start}: {len(trace)} sightings, host iBSP {host_s:.1f} s")
            del sess
            if cuda:
                torch.cuda.empty_cache()
        launches = {k.__name__: k.launches for k in kernels}
    finally:
        release_pinned()
        for k, n in zip(kernels, outer):
            k.launches += n
    recs["launches"] = launches
    recs["launches_by_call_shape"] = {
        f"{k} {c}": n for (k, c), n in sorted(shapes.items())}
    log(f"session launches: {json.dumps(launches)}")
    log("session launches by call shape: "
        + json.dumps(recs["launches_by_call_shape"]))
    for name, v in launches.items():
        need(sum(n for (k, _), n in shapes.items() if k == name) == v,
             f"{name}: session launches by call shape do not sum to {v}")
        need(not cuda or v > 0,
             f"{name} was not launched on the session path")
    return recs


# ---------------------------------------------------------------------------
# phase 6c: the cluster runtime on the GoFS deployment
# ---------------------------------------------------------------------------

# worker processes of phase 6c, sharing the one card (TR_SMALL's 8
# partitions: 4 each)
CLUSTER_PROCESSES = 2
# the longest phase 6c waits on its workers, and on its killed child
CLUSTER_WAIT = 900.0
# instances a span of the resumable run covers (TR_SMALL: 4 spans of 12)
RESUME_CHUNK = 12

# the killed child of phase 6c: a checkpointed SSSP that dies during its
# second span ("mid-superstep"), after the first span's snapshot
RESUME_CHILD = """\
import os, sys
root, ckdir, chunk, device = sys.argv[1:5]
from repro_torch.core.engine import TemporalEngine
real, calls = TemporalEngine.run_many, {"n": 0}
def dying_run_many(self, *a, **k):
    calls["n"] += 1
    if calls["n"] == 2:
        os._exit(1)
    return real(self, *a, **k)
TemporalEngine.run_many = dying_run_many
from repro_torch.gofs import GoFSStore
from repro_torch.gopher import GopherSession
sess = GopherSession(GoFSStore(root), device=device)
sess.run(sess.plan("sssp", source=0), checkpoint_dir=ckdir,
         checkpoint_chunk=int(chunk))
os._exit(0)  # unreachable: the second span dies first
"""


def cluster_worker(spec) -> int:
    """One worker process of phase 6c (``chip_smoke.py --cluster-worker
    SPEC``): ``repro_torch.launch.cluster_graph.worker_run`` on its shard
    with the graph kernels' launches counted by call shape and by walk,
    then SSSP again in each kernel mode its auto plans did not launch,
    over the first CLUSTER_OTHER_MODE_PACKS time packs, held bitwise
    against its first SSSP's first instances.  Writes its record beside
    its ``.npz``."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.cluster.runtime import init_cluster
    from repro_torch.configs import get_graph_config
    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import \
        fused_step_cuda
    from repro_torch.launch import cluster_graph as cg

    args = cg.build_parser().parse_args(spec["argv"])
    kernels = {"spmv": spmv_blocked_cuda, "fused": fused_step_cuda}
    rt = init_cluster(transport=args.transport, timeout=CLUSTER_WAIT)
    try:
        for k in kernels.values():
            k.launches = 0
        w0 = walk_counts()
        t0 = time.perf_counter()
        with PeakRSS() as rss, call_shapes() as shapes:
            results = cg.worker_run(args, rt)
            auto = {k.__name__: k.launches for k in kernels.values()}
            others = [m for m, k in kernels.items() if k.launches == 0]
            cfg = get_graph_config(args.size)
            n, window = first_packs(args.deploy, CLUSTER_OTHER_MODE_PACKS)
            for mode in others:
                store = GoFSStore(args.deploy, cache_slots=args.cache_slots,
                                  vertex_projection=("plate",
                                                     "outdeg_active"),
                                  edge_projection=("latency", "active"),
                                  time_range=window)
                sess = GopherSession(store, block_size=cfg.block_size,
                                     device=args.device, cluster=rt,
                                     use_pallas=mode)
                again = cg.run_apps(sess, ["sssp"])["sssp"]
                same_prefix(again, results["sssp"], n,
                            f"worker {rt.process_id}: sssp ({mode})")
                del sess, store
        seconds = time.perf_counter() - t0
        rec = {
            "process_id": rt.process_id,
            "parts": list(rt.partition_shard(spec["n_parts"])),
            "device": args.device,
            "card": torch.cuda.get_device_name(0)
            if torch.cuda.is_available() else None,
            "seconds": seconds,
            "launches": {k.__name__: k.launches for k in kernels.values()},
            "auto_plan_launches": auto,
            "rerun_modes": others,
            "rerun_instances": n,
            "launches_by_call_shape": {
                f"{k} {c}": n for (k, c), n in sorted(shapes.items())},
            "launches_by_walk": check_walks(
                f"cluster worker {rt.process_id}", shapes, w0,
                walk_counts()),
            "exchange": rt.exchange.stats(),
            "staged_bytes": {app: int(r["staged_bytes"])
                             for app, r in results.items()},
            "host_peak_rss_gb": rss.peak_gb,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else None,
        }
        with open(os.path.join(args.out,
                               f"worker_{rt.process_id}.json"), "w") as f:
            json.dump(rec, f)
        rt.barrier("done")
    finally:
        rt.close()
    return 0


def cluster_phase(root, cfg, held, device="cuda", log=print):
    """Phase 6c: the cluster runtime on phase 6's deployment.

    CLUSTER_PROCESSES worker processes (:func:`cluster_worker`, each
    driving ``repro_torch.launch.cluster_graph``'s worker over the TCP
    exchange) share the card, each staging its half of the partitions
    through ``shard_stream``; their SSSP and PageRank are held bitwise
    against phase 6's session runs (``held``), their staged bytes below
    the single-process session's, and their launches, by call shape and
    by walk, must reach both graph kernels on every worker (the other
    mode's SSSP over the first CLUSTER_OTHER_MODE_PACKS time packs, held
    bitwise in the worker).  Then a checkpointed SSSP
    (spans of RESUME_CHUNK) in a child process that dies in its second
    span; exactly one snapshot must be committed, and the resumed run
    must be bitwise equal to phase 6's session SSSP.  Returns the phase's
    records."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession
    from repro_torch.launch import cluster_graph as cg
    from repro_torch.train import checkpoint as ckpt

    cuda = device == "cuda"  # a CPU rehearsal checks control flow only
    out = tempfile.mkdtemp(prefix="cluster_smoke_")
    recs = {}
    try:
        # 1. the workers, launches counted in each
        argv = ["--worker", "--num-processes", str(CLUSTER_PROCESSES),
                "--size", cfg.name.rsplit("-", 1)[-1], "--deploy", root,
                "--out", out, "--apps", "sssp,pagerank",
                "--transport", "tcp", "--device", device]
        spec = json.dumps({"argv": argv, "n_parts": cfg.num_partitions})
        coordinator = f"127.0.0.1:{cg.free_port()}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--cluster-worker",
             spec], env=cg.worker_env(coordinator, CLUSTER_PROCESSES, pid,
                                      "tcp"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(CLUSTER_PROCESSES)]
        try:
            cg.wait_workers(procs, CLUSTER_WAIT)
        except SystemExit as e:
            raise SmokeFailure(f"cluster: {e}") from None
        wall = time.perf_counter() - t0
        workers = []
        for pid in range(CLUSTER_PROCESSES):
            with open(os.path.join(out, f"worker_{pid}.json")) as f:
                workers.append(json.load(f))
            res = np.load(cg.worker_results_path(out, pid))
            w = workers[-1]
            need(w["device"] == device and (not cuda or w["card"]),
                 f"cluster worker {pid} ran on {w['device']}")
            for app in ("sssp", "pagerank"):
                ref = held[app]
                for key, want in (("values", ref.values),
                                  ("final", ref.final),
                                  ("supersteps", ref.stats["supersteps"])):
                    need(cg.same_bits(res[f"{app}/{key}"], want),
                         f"cluster worker {pid}: {app} {key} differ from "
                         f"phase 6's single-process session")
                need(w["staged_bytes"][app] < held["staged_bytes"],
                     f"cluster worker {pid}: {app} staged "
                     f"{w['staged_bytes'][app]} bytes, the single-process "
                     f"session {held['staged_bytes']}")
        launches = {k: sum(w["launches"][k] for w in workers)
                    for k in workers[0]["launches"]}
        by_shape: dict = {}
        for w in workers:
            for c, n in w["launches_by_call_shape"].items():
                by_shape[c] = by_shape.get(c, 0) + n
        for k, v in launches.items():
            need(sum(n for c, n in by_shape.items()
                     if c.startswith(k + " ")) == v,
                 f"{k}: cluster launches by call shape do not sum to {v}")
            need(not cuda or all(w["launches"][k] > 0 for w in workers),
                 f"{k} was not launched by every cluster worker")
        recs.update(
            processes=CLUSTER_PROCESSES, wall_seconds=wall,
            parts=[w["parts"] for w in workers],
            worker_seconds=[w["seconds"] for w in workers],
            exchange=[w["exchange"] for w in workers],
            staged_bytes_per_host=[w["staged_bytes"] for w in workers],
            staged_bytes_single_process=held["staged_bytes"],
            host_peak_rss_gb=[w["host_peak_rss_gb"] for w in workers],
            peak_device_gb=[w["peak_device_gb"] for w in workers],
            rerun_modes=[w["rerun_modes"] for w in workers],
            rerun_instances=[w["rerun_instances"] for w in workers],
            launches=launches, launches_by_call_shape=by_shape,
            launches_by_walk=[w["launches_by_walk"] for w in workers],
            worker_launches_by_call_shape=[w["launches_by_call_shape"]
                                           for w in workers])

        # 2. a resumable run killed in its second span, then resumed
        ckdir = os.path.join(out, "ckpt")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", RESUME_CHILD, root, ckdir,
             str(RESUME_CHUNK), device],
            env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
            text=True, timeout=CLUSTER_WAIT)
        killed_s = time.perf_counter() - t0
        need(child.returncode == 1, f"resumable child exited with "
                                    f"{child.returncode}:\n{child.stderr}")
        steps = ckpt.list_steps(ckdir)
        need(steps == [RESUME_CHUNK], f"resumable run: committed snapshots "
                                      f"{steps}, want [{RESUME_CHUNK}]")
        sess = GopherSession(GoFSStore(root), device=device)
        plan = sess.plan("sssp", source=0)
        t0 = time.perf_counter()
        res = sess.run(plan, checkpoint_dir=ckdir,
                       checkpoint_chunk=RESUME_CHUNK, resume=True)
        resume_s = time.perf_counter() - t0
        ref = held["sssp"]
        for key, got, want in (
                ("values", res.engine.values, ref.values),
                ("final", res.engine.final, ref.final),
                ("supersteps", res.engine.stats["supersteps"],
                 ref.stats["supersteps"])):
            need(cg.same_bits(got, want),
                 f"resumed sssp: {key} differ from phase 6's session")
        recs.update(killed_child_seconds=killed_s,
                    resume_seconds=resume_s,
                    snapshots_after_kill=steps,
                    snapshots_after_resume=ckpt.list_steps(ckdir))
        del sess, res
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log("phase cluster: " + json.dumps({
        k: recs[k] for k in (
            "processes", "parts", "wall_seconds", "worker_seconds",
            "exchange", "staged_bytes_per_host",
            "staged_bytes_single_process", "host_peak_rss_gb",
            "peak_device_gb", "rerun_modes", "rerun_instances",
            "killed_child_seconds",
            "resume_seconds", "snapshots_after_kill")}))
    log(f"cluster path launches: {json.dumps(recs['launches'])}")
    log("cluster path launches by call shape: "
        + json.dumps(recs["launches_by_call_shape"]))
    log("cluster path launches by walk: "
        + json.dumps(recs["launches_by_walk"]))
    return recs


# ---------------------------------------------------------------------------
# phase 6b: streaming ingestion and warm serving on a growing collection
# ---------------------------------------------------------------------------

# instances a stream-phase append adds: the first opens a new time pack,
# the second rewrites that partial pack (TR_SMALL: 40 deployed, then 4
# and 4, at 20 instances a pack)
STREAM_APPEND = 4
# instances phase 6b deploys first: the first time pack (a depth cut of
# the growing collection, 20 + 4 + 4 of TR_SMALL's 48, listed on the
# ``stream path cuts`` line; it deployed 40 before the cut)
STREAM_FIRST = 20
# the longest the stream phase waits on the service (every wait has one)
STREAM_WAIT = 900.0


def disk_files(root):
    """{path: (bytes, mtime ns)} of every file under ``root``."""
    import os

    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


class Timed:
    """Wrap the callable ``owner.name`` in place, recording each call's
    (seconds, ``note(result)``) in ``calls`` (``note`` keeps no reference
    to a large result); ``sync`` runs before the clock stops (a CUDA
    synchronise, so the seconds cover the device work).  ``restore()``
    puts the callable back."""

    def __init__(self, owner, name, sync=None, note=lambda out: out):
        self.owner, self.name, self.calls = owner, name, []
        self.real = getattr(owner, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.real(*args, **kw)
            if sync is not None:
                sync()
            self.calls.append((time.perf_counter() - t0, note(out)))
            return out

        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.real)


def stream_phase(cfg, keep, card, device="cuda", log=print):
    """Streaming ingestion and warm serving on a growing collection at
    ``cfg``'s full width: the first ``I - 2 * STREAM_APPEND`` instances
    deployed with phase 6's knobs, then two appends of STREAM_APPEND
    instances from this thread while a ``GopherService`` serves (the
    second append rewrites the tail pack the first opened).  The service
    (a staging budget that holds the batch) answers the query phase's 32
    SSSP sources before the appends, and the same 32 with an N-hop group
    of 4 in one admission after them; its ``sssp`` subscription
    (source 0) delivers full, incremental, incremental; a second session
    with ``use_pallas="fused"`` tails the same store.  Everything is held
    bit for bit against phases 5b and 6 (``keep["query"]``,
    ``keep["session_held"]``).  Records, each with the card: deploy and
    append seconds and bytes written, free disk, refresh, staged-batch
    extension and re-upload seconds, each tail update's seconds, the
    service's latencies and batches, staging-cache counters, host peak
    RSS and peak device memory.  Returns the phase's records."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.core.engine as engine_mod
    from repro_torch.core.graph import TimeSeriesGraph
    from repro_torch.core.semiring import INF
    from repro_torch.gofs import GoFSStore, append_instances, deploy_collection
    from repro_torch.gofs.prefetch import release_pinned
    from repro_torch.gopher import GopherService, GopherSession

    cuda = device == "cuda"  # a CPU rehearsal checks control flow only
    bg, col = keep["bg"], keep["in_memory"]["col"]
    srcs, qref = keep["query"]["sources"], keep["query"]["result"]
    held = keep["session_held"]
    a, n0 = STREAM_APPEND, min(STREAM_FIRST, len(col) - 2 * STREAM_APPEND)
    I = n0 + 2 * a  # the grown collection: the first I of TR_SMALL's
    Q = len(srcs)
    B = bg.block_size
    per_instance = bg.n_parts * (bg.t_max + bg.tb_max) * B * B * 4
    recs = {"card": card, "cut": {"first_deployment_instances": n0,
                                  "grown_instances": I}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def report(name, **kw):
        cur, peak = host_rss_gb()
        rec = dict(kw, host_rss_gb=cur, host_peak_rss_gb=peak, card=card)
        if cuda:
            rec["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
        recs[name] = rec
        log(f"phase stream_{name}: {json.dumps(rec)}")

    def part(lo, hi):
        return TimeSeriesGraph(template=col.template,
                               instances=col.instances[lo:hi])

    def same(got, want, what):  # bit for bit: -0 is not +0
        same_bits(torch.as_tensor(np.asarray(got)),
                  torch.as_tensor(np.asarray(want)), what)

    def same_lane(eng, q, ref, n, what):
        """Lane ``q`` of ``eng`` (values, final, counts) against lane ``q``
        of ``ref`` over its first ``n`` instances."""
        same(eng.values[q], ref.values[q][:n], f"{what}: values")
        same(eng.final[q], ref.values[q][n - 1], f"{what}: final")
        for k in ("supersteps", "local_sweeps"):
            same(eng.stats[k][q], ref.stats[k][q][:n], f"{what}: {k}")

    def same_run(got, want, what):
        for f in ("values", "final"):
            same(getattr(got, f), getattr(want, f), f"{what}: {f}")
        for k in ("supersteps", "local_sweeps"):
            same(got.stats[k], want.stats[k], f"{what}: {k}")

    root = tempfile.mkdtemp(prefix="gofs_stream_")
    uploads = Timed(engine_mod, "_device_put", sync,
                    note=lambda t: int(t.nbytes))
    svc = None
    try:
        # 1. deploy the prefix with phase 6's knobs
        free0 = shutil.disk_usage(root).free
        t0 = time.perf_counter()
        deploy_collection(part(0, n0), cfg, root,
                          sparse_absent={"latency": INF})
        files = disk_files(root)
        report("deploy", seconds=time.perf_counter() - t0, instances=n0,
               collection_instances=I,
               bytes_on_disk=sum(n for n, _ in files.values()),
               disk_free_gb_before=free0 / 1e9,
               disk_free_gb_after=shutil.disk_usage(root).free / 1e9)

        # 2. the service, its subscription, the fused tail session
        budget = int(1.25 * I * per_instance)  # holds the grown batch
        svc = GopherService(GoFSStore(root), device=device,
                            staging_cache_bytes=budget,
                            max_batch_queries=Q + 4, poll_interval=0.05)
        sess = svc.session
        refreshes = Timed(sess, "refresh")
        extends = Timed(sess, "_extend_staging_cache", sync)
        tails = Timed(sess, "tail", sync, note=lambda u: u.mode)
        fused = GopherSession(GoFSStore(root), device=device,
                              use_pallas="fused")
        f_updates, f_seconds = [], []

        def fused_tail():
            sync()
            t0 = time.perf_counter()
            f_updates.append(fused.tail("sssp", source=0))
            sync()
            f_seconds.append(time.perf_counter() - t0)

        with PeakRSS() as rss, svc:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sub = svc.subscribe("sssp", source=0)
            updates = [sub.wait_update(1, timeout=STREAM_WAIT)]
            t0 = time.perf_counter()
            before = [t.wait(STREAM_WAIT) for t in svc.submit_many(
                [("sssp", {"source": s}) for s in srcs])]
            before_s = time.perf_counter() - t0
            stats = [sess.staging_cache_stats()]
            report("serve_before", seconds=before_s, queries=Q,
                   instances=n0, staging_cache=stats[0],
                   upload_seconds=sum(s for s, _ in uploads.calls),
                   upload_bytes=sum(n for _, n in uploads.calls),
                   tail_seconds=tails.calls[0][0])
            fused_tail()

            # 3. two appends from this thread while the service runs
            for k, (lo, hi) in enumerate(((n0, n0 + a), (n0 + a, I)), 2):
                snap = disk_files(root)
                free_b = shutil.disk_usage(root).free
                n_ext, n_up = len(extends.calls), len(uploads.calls)
                t0 = time.perf_counter()
                meta = append_instances(part(lo, hi), root)
                append_s = time.perf_counter() - t0
                after = disk_files(root)
                written = sum(n for p, (n, m) in after.items()
                              if snap.get(p) != (n, m))
                updates.append(sub.wait_update(k, timeout=STREAM_WAIT))
                stats.append(sess.staging_cache_stats())
                fused_tail()
                grew = {f: stats[-1][f] - stats[-2][f] for f in (
                    "staged_bytes", "staging_passes", "evictions", "hits")}
                need(grew == {"staged_bytes": a * per_instance,
                              "staging_passes": 1, "evictions": 0,
                              "hits": 0},
                     f"append {k - 1}: the staging cache grew by {grew}, "
                     f"not the new {a} instances' fill once "
                     f"({a * per_instance} bytes)")
                report(f"append_{k - 1}", instances=[lo, hi],
                       version=meta["version"], seconds=append_s,
                       bytes_written=written,
                       files_written=sum(1 for p, v in after.items()
                                         if snap.get(p) != v),
                       disk_free_gb_before=free_b / 1e9,
                       disk_free_gb_after=shutil.disk_usage(root).free
                       / 1e9,
                       refresh_seconds=[s for s, changed in refreshes.calls
                                        if changed][-1],
                       extend_seconds=[s for s, _ in
                                       extends.calls[n_ext:]],
                       tail_seconds=tails.calls[-1][0],
                       fused_tail_seconds=f_seconds[-1],
                       new_uploads=len(uploads.calls) - n_up,
                       staging_cache=stats[-1])

            # 4. after the appends: 32 sources and N-hop 4, one admission
            n_up = len(uploads.calls)
            t0 = time.perf_counter()
            after_res = [t.wait(STREAM_WAIT) for t in svc.submit_many(
                [("sssp", {"source": s}) for s in srcs]
                + [("nhop", {"source": s, "n_hops": 4}) for s in srcs[:4]])]
            after_s = time.perf_counter() - t0
            up = uploads.calls[n_up:]
            rep = svc.report()
            sub.cancel()
        report("serve_after", seconds=after_s, queries=Q + 4,
               instances=I, reupload_seconds=sum(s for s, _ in up),
               reupload_bytes=sum(n for _, n in up),
               service=rep, host_peak_rss_in_phase_gb=rss.peak_gb)
        need(rep["batches"] == 2 and rep["widest_batch"] == Q + 4
             and rep["appends_observed"] == 2,
             f"stream: the service's batches {rep}")

        # 5. checks, bit for bit
        eng_b = before[0].engine
        need(eng_b.values.shape == (Q, n0, len(bg.part_of)),
             "stream: the first batch did not run the 32 lanes together")
        for q in range(Q):
            same_lane(eng_b, q, qref, n0, f"stream before the appends, "
                                          f"lane {q} (source {srcs[q]})")
            same(before[q].output["final"], eng_b.final[q],
                 f"stream: ticket {q}'s final against its lane")
        eng_a = after_res[0].engine
        for q in range(Q):
            same_lane(eng_a, q, qref, I, f"stream after the appends, "
                                         f"lane {q} (source {srcs[q]})")
            same(after_res[q].output["final"], qref.values[q][I - 1],
                 f"stream: ticket {q}'s final after the appends")
        for q in range(4):
            same(after_res[Q + q].output["histograms"],
                 held["nhop_q4"][q][:I],
                 f"stream: N-hop lane {q} against phase 6's session")
        modes = [(u.mode, u.new_instances) for u in updates]
        need(modes == [("full", n0), ("incremental", a),
                       ("incremental", a)],
             f"stream: subscription updates {modes}")
        need([(u.mode, u.new_instances) for u in f_updates] == modes,
             "stream: the fused tail's updates differ in mode")
        for i, (u, fu) in enumerate(zip(updates, f_updates)):
            same_run(fu.result.engine, u.result.engine,
                     f"stream: fused tail update {i}")
        last, cold = updates[-1].result.engine, held["sssp"]
        same(last.values, cold.values[:I],
             "stream: the last update's values against phase 6's cold "
             "session")
        same(last.final, cold.values[I - 1],
             "stream: the last update's final against phase 6's cold "
             "session")
        for k in ("supersteps", "local_sweeps"):
            same(last.stats[k], cold.stats[k][:I],
                 f"stream: the last update's {k} against phase 6's cold "
                 f"session")
        report("checks", lanes=Q, nhop_lanes=4,
               updates=[dict(mode=m, new_instances=n) for m, n in modes],
               tail_seconds=[s for s, _ in tails.calls],
               fused_tail_seconds=f_seconds,
               per_instance_fill_bytes=per_instance,
               staging_cache_bytes=budget)
    finally:
        uploads.restore()
        if svc is not None:
            svc.stop()
        release_pinned()
        shutil.rmtree(root, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 7: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20, warm=3, graph=True) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls.
    ``graph=True`` captures the calls in one CUDA graph and times its
    replay: device time alone.  ``graph=False`` times eager calls, which
    also counts the time the card waits for the host to launch."""
    import torch

    for _ in range(warm):
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


FLUSH_BYTES = 256 << 20  # read between cold calls: five times the L2


def cold_ms(fn, reps=20) -> float:
    """Device milliseconds per call of ``fn`` with its inputs out of L2: a
    FLUSH_BYTES read before each call, the pairs replayed from one CUDA
    graph, less the reads alone.  A decode step's attention finds its
    layer's K/V so, after the other layers' reads; back-to-back replays
    (:func:`cuda_ms`) of a 33.6 MB cache read much of it from the 50 MB
    L2."""
    import torch

    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    total = torch.empty((), device="cuda")

    def read():
        torch.sum(flush, dim=0, out=total)

    def read_then_call():
        read()
        fn()

    return cuda_ms(read_then_call, reps) - cuda_ms(read, reps)


def dense_operator(tiles, rows, cols, nvb_out, nvb_in):
    """(P, nvb_out*B, nvb_in*B) dense matrix of the blocked operator
    y = A^T x (block (c, r) = W^T) — the library call's input, built
    outside any timing."""
    import torch

    P, T, B, _ = tiles.shape
    m = torch.zeros((P, nvb_out, nvb_in, B, B), dtype=tiles.dtype,
                    device=tiles.device)
    p, t = torch.nonzero(cols >= 0, as_tuple=True)
    m[p, cols[p, t].long(), rows[p, t].long()] = \
        tiles[p, t].transpose(-1, -2)
    return m.permute(0, 1, 3, 2, 4).reshape(P, nvb_out * B, nvb_in * B)


def kernel_report(keep, launches, shape_launches, query_launches, card,
                  rate, cluster=None):
    """One JSON record per kernel: the top-level numbers are its hot
    main-path call (the min-plus local sweep of the SSSP fixpoint); every
    main-path call shape is listed under ``calls``, with its launches on
    the main path (``shape_launches``, from :func:`call_shapes`), and then
    the Q-lane form of each call shape at Q in QUERY_SWEEP (held against
    plain, timed, with ``torch.bmm`` over the lanes as the plus-mul
    library call), with its launches on the query path
    (``query_launches``), a skewed control at Q = 32, and wrong controls
    that must fail the comparison.  ``q_lanes`` summarises the Q = 32
    calls.  ``cluster`` (phase 6c's records) adds each call shape at a
    cluster shard's P_local = 4 partitions, both shards, with the
    launches of the worker that owns the shard."""
    import torch

    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.core.superstep import _publish, graph_plans
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda
    from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
    from repro_torch.kernels.walk_plan import (
        default_chunk, to_device, walk_plan)

    bg, eng = keep["bg"], keep["eng"]
    rows, cols, brows, bcols = eng._index
    plan, bplan = eng._plans["plan"], eng._plans["bplan"]
    vmask = eng._tail[3]
    P, Vp, B = bg.n_parts, bg.vp, bg.block_size
    nvb, nbb = Vp // B, bg.num_boundary // B
    dg_like = eng._device_graph(keep["sssp_tiles"], keep["sssp_btiles"],
                                eng._index)
    x_mp = keep["x_sssp"]
    b_mp = _publish(x_mp, dg_like, MIN_PLUS, eng.comm)
    x_pm = keep["x_pr"]
    b_pm = _publish(x_pm, dg_like, PLUS_MUL, eng.comm)
    n_local = int((cols >= 0).sum())
    n_bound = int((bcols >= 0).sum())
    tile_b = B * B * 4

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    calls = {"spmv_blocked_cuda": [], "fused_step_cuda": []}

    def record(kernel, name, sr, kfn, pfn, lfn, moved, pairs, lanes=None,
               launched=None):
        """Hold ``kfn`` against ``pfn`` (and ``lfn``, the library call,
        where there is one) and time all three.  ``moved``: the bytes the
        call must move; ``pairs``: its multiply-add (add-min) pairs, one
        FP32 instruction each for plus-mul (FMA), two for min-plus (add,
        min).  ``lanes``: Q of a Q-lane call, whose launches are the query
        path's; ``launched``: the launches of a call of another path."""
        wrapper = spmv_blocked_cuda if kernel == "spmv_blocked_cuda" \
            else fused_step_cuda
        before = dict(wrapper.launches_by_walk)
        kout, pout = kfn(), pfn()
        walk = [w for w, n in wrapper.launches_by_walk.items()
                if n > before[w]]
        need(len(walk) == 1, f"{name}: launched walks {walk}")
        if isinstance(kout, tuple):
            kc, pc = kout[1], pout[1]
            need((kc is None and pc is None) or torch.equal(kc, pc),
                 f"{name}: votes differ")
            kout, pout = kout[0], pout[0]
        err, used = compare(kout, pout, sr.name, name)
        if lfn is not None:  # the yardstick computes the same function
            compare(lfn().reshape(pout.shape), pout, sr.name,
                    name + " library call")
        instr = pairs * (2 if sr is MIN_PLUS else 1)
        t_bytes, t_ops = moved / rate, instr / FP32_ISSUE
        src = shape_launches if lanes is None else query_launches
        rec = {
            "call": name, "semiring": sr.name,
            "launches": src.get((kernel, name), 0) if launched is None
            else launched,
            "ms": cuda_ms(kfn), "eager_ms": cuda_ms(kfn, graph=False),
            "plain_ms": cuda_ms(pfn),
            "library_ms": None if lfn is None else cuda_ms(lfn),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "issue_ms": t_ops * 1e3,
            "bytes": moved, "instructions": instr,
            "max_abs_err": err, "limit_used": used,
            "max_abs_plain": float(pout.abs().max()), "walk": walk[0],
        }
        if lanes is not None:
            rec["lanes"] = lanes
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        calls[kernel].append(rec)

    # -- spmv: local sweep and consume, both semirings --------------------
    for sr, x, bnd, tl, btl in (
            (MIN_PLUS, x_mp, b_mp, keep["sssp_tiles"], keep["sssp_btiles"]),
            (PLUS_MUL, x_pm, b_pm, keep["pr_tiles"], keep["pr_btiles"])):
        lib_local = lib_bound = None
        if sr is PLUS_MUL:
            a_loc = dense_operator(tl, rows, cols, nvb, nvb)
            a_bnd = dense_operator(btl, brows, bcols, nvb, nbb)
            xs, bs = x[..., None], bnd[None, :, None]
            lib_local = lambda: torch.bmm(a_loc, xs)  # noqa: E731
            lib_bound = lambda: torch.matmul(a_bnd, bs)  # noqa: E731
        moved = n_local * tile_b + nbytes(rows, cols, x) + P * Vp * 4
        record("spmv_blocked_cuda", f"local sweep {sr.name}", sr,
               lambda: spmv_blocked_cuda(tl, rows, cols, x, sr, plan=plan),
               lambda: spmv_blocked_ref(tl, rows, cols, x, sr),
               lib_local, moved, n_local * B * B)
        moved = (n_bound * tile_b + nbytes(brows, bcols, bnd) + P * Vp * 4)
        record("spmv_blocked_cuda", f"consume {sr.name}", sr,
               lambda: spmv_blocked_cuda(btl, brows, bcols, bnd[None], sr,
                                         n_out_blocks=nvb, plan=bplan),
               lambda: spmv_blocked_ref(btl, brows, bcols, bnd[None], sr,
                                        n_out_blocks=nvb),
               lib_bound, moved, n_bound * B * B)

        # -- fused: the main path's call shapes -------------------------
        # SSSP sweeps and consumes with the combine and the vote; PageRank
        # takes neither (superstep._spmv_only, superstep._consume)
        xs3 = x.reshape(P, nvb, B)
        vm3 = vmask.reshape(P, nvb, B)
        b3 = bnd.reshape(1, nbb, B)
        if sr is MIN_PLUS:
            shapes = {"sweep": (tl, rows, cols, xs3, xs3, xs3, None),
                      "consume": (btl, brows, bcols, b3, xs3,
                                  torch.flip(xs3, (2,)).contiguous(), None)}
        else:
            shapes = {"spmv": (tl, rows, cols, xs3, None, None, a_loc),
                      "consume": (btl, brows, bcols, b3, None, None, a_bnd)}
        for name, (tt, rr, cc, xin, comb, xref, a) in shapes.items():
            n_t = n_local if tt is tl else n_bound
            pl = plan if tt is tl else bplan
            vm = None if xref is None else vm3
            lfn = None
            if a is not None:  # plus-mul, no combine
                xin_v = xin.reshape(xin.shape[0], -1, 1)
                lfn = (lambda a=a, xin_v=xin_v:
                       torch.bmm(a, xin_v.expand(P, -1, -1)))
            # x_out written; x_comb, x_ref, the mask and the votes where used
            states = nbytes(xs3) + sum(
                nbytes(t_) for t_ in (comb, xref, vm) if t_ is not None) + (
                P * 4 if xref is not None else 0)
            moved = n_t * tile_b + nbytes(rr, cc, xin) + states
            record("fused_step_cuda", f"{name} {sr.name}", sr,
                   lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                   xref=xref, vm=vm, pl=pl: fused_step_cuda(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb,
                       plan=pl),
                   lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                   xref=xref, vm=vm: fused_step_ref(
                       tt, rr, cc, xin, comb, xref, vm, sr, n_out_blocks=nvb),
                   lfn, moved, n_t * B * B)

    # skewed control: partition 0's boundary runs gathered into one output
    # block, so one run holds all its tiles (the walk plan spreads it over
    # many CTAs); min-plus, held against plain and timed like the rest
    skew = bcols.clone()
    skew[0][skew[0] >= 0] = 0
    splan = to_device(walk_plan(skew.cpu().numpy(), nvb,
                                chunk=default_chunk(B)), skew.device)
    btl, b3 = keep["sssp_btiles"], b_mp.reshape(1, nbb, B)
    xs3 = x_mp.reshape(P, nvb, B)
    xref = torch.flip(xs3, (2,)).contiguous()
    vm3 = vmask.reshape(P, nvb, B)
    name = "consume min_plus, skewed control (partition 0 in one block)"
    record("spmv_blocked_cuda", name, MIN_PLUS,
           lambda: spmv_blocked_cuda(btl, brows, skew, b_mp[None], MIN_PLUS,
                                     n_out_blocks=nvb, plan=splan),
           lambda: spmv_blocked_ref(btl, brows, skew, b_mp[None], MIN_PLUS,
                                    n_out_blocks=nvb),
           None, n_bound * tile_b + nbytes(brows, skew, b_mp) + P * Vp * 4,
           n_bound * B * B)
    record("fused_step_cuda", name, MIN_PLUS,
           lambda: fused_step_cuda(btl, brows, skew, b3, xs3, xref, vm3,
                                   MIN_PLUS, plan=splan),
           lambda: fused_step_ref(btl, brows, skew, b3, xs3, xref, vm3,
                                  MIN_PLUS),
           None, n_bound * tile_b + nbytes(brows, skew, b3, xs3, xs3, xref,
                                           vm3) + P * 4,
           n_bound * B * B)

    # -- a cluster shard's call shapes: P_local = 4, both shards ----------
    for pid, (lo, hi) in enumerate(cluster["parts"] if cluster else ()):
        wl = cluster["worker_launches_by_call_shape"][pid]
        sh = slice(lo, hi)
        s_rows, s_cols, s_brows, s_bcols = (a[sh] for a in eng._index)
        s_plans = graph_plans(bg, s_cols.device, parts=(lo, hi))
        s_vm3 = vmask[sh].reshape(hi - lo, nvb, B)
        s_nl, s_nb = int((s_cols >= 0).sum()), int((s_bcols >= 0).sum())
        sfx = f" P={hi - lo} [{lo}:{hi}]"
        for sr, x, bnd, tl, btl in (
                (MIN_PLUS, x_mp, b_mp, keep["sssp_tiles"],
                 keep["sssp_btiles"]),
                (PLUS_MUL, x_pm, b_pm, keep["pr_tiles"],
                 keep["pr_btiles"])):
            stl, sbtl, sx = tl[sh], btl[sh], x[sh].contiguous()
            Pl = hi - lo
            lib = {}  # plus-mul yardsticks: the shard's dense operators
            if sr is PLUS_MUL:
                s_loc = dense_operator(stl, s_rows, s_cols, nvb, nvb)
                s_bnd = dense_operator(sbtl, s_brows, s_bcols, nvb, nbb)
                lib = {"local": lambda: torch.bmm(s_loc, sx[..., None]),
                       "consume": lambda: torch.matmul(
                           s_bnd, bnd[None, :, None]),
                       "spmv": lambda: torch.bmm(s_loc, sx[..., None])}
            record("spmv_blocked_cuda", f"local sweep {sr.name}{sfx}", sr,
                   lambda stl=stl, sx=sx, sr=sr: spmv_blocked_cuda(
                       stl, s_rows, s_cols, sx, sr, plan=s_plans["plan"]),
                   lambda stl=stl, sx=sx, sr=sr: spmv_blocked_ref(
                       stl, s_rows, s_cols, sx, sr),
                   lib.get("local"), s_nl * tile_b + nbytes(s_rows, s_cols, sx)
                   + Pl * Vp * 4, s_nl * B * B,
                   launched=wl.get(f"spmv_blocked_cuda local sweep "
                                   f"{sr.name}", 0))
            record("spmv_blocked_cuda", f"consume {sr.name}{sfx}", sr,
                   lambda sbtl=sbtl, bnd=bnd, sr=sr: spmv_blocked_cuda(
                       sbtl, s_brows, s_bcols, bnd[None], sr,
                       n_out_blocks=nvb, plan=s_plans["bplan"]),
                   lambda sbtl=sbtl, bnd=bnd, sr=sr: spmv_blocked_ref(
                       sbtl, s_brows, s_bcols, bnd[None], sr,
                       n_out_blocks=nvb),
                   lib.get("consume"),
                   s_nb * tile_b + nbytes(s_brows, s_bcols, bnd)
                   + Pl * Vp * 4, s_nb * B * B,
                   launched=wl.get(f"spmv_blocked_cuda consume {sr.name}",
                                   0))
            xs3 = sx.reshape(Pl, nvb, B)
            b3 = bnd.reshape(1, nbb, B)
            if sr is MIN_PLUS:
                fshapes = {"sweep": (stl, s_rows, s_cols, xs3, xs3, xs3,
                                     "plan"),
                           "consume": (sbtl, s_brows, s_bcols, b3, xs3,
                                       torch.flip(xs3, (2,)).contiguous(),
                                       "bplan")}
            else:
                fshapes = {"spmv": (stl, s_rows, s_cols, xs3, None, None,
                                    "plan"),
                           "consume": (sbtl, s_brows, s_bcols, b3, None,
                                       None, "bplan")}
            for name, (tt, rr, cc, xin, comb, xref, pk) in fshapes.items():
                n_t = s_nl if pk == "plan" else s_nb
                vm = None if xref is None else s_vm3
                states = nbytes(xs3) + sum(
                    nbytes(t_) for t_ in (comb, xref, vm) if t_ is not None
                ) + (Pl * 4 if xref is not None else 0)
                record("fused_step_cuda", f"{name} {sr.name}{sfx}", sr,
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm, pk=pk, sr=sr: fused_step_cuda(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb, plan=s_plans[pk]),
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm, sr=sr: fused_step_ref(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb),
                       lib.get(name), n_t * tile_b + nbytes(rr, cc, xin)
                       + states, n_t * B * B,
                       launched=wl.get(f"fused_step_cuda {name} {sr.name}",
                                       0))

    # -- the query axis: each call shape with Q lanes ---------------------
    gen = torch.Generator(device=x_mp.device).manual_seed(7)

    def lanes_of(x, Q, sr):
        """Q states near ``x``: lane 0 is x, the others moved by up to
        one unit (min-plus) or ten percent (plus-mul); inf stays inf."""
        u = torch.rand((Q,) + tuple(x.shape), generator=gen,
                       device=x.device)
        u[0] = 0
        return x + u if sr is MIN_PLUS else x * (1 + 0.1 * u)

    def bmm_lanes(a, xin, Q):
        """The library call of a plus-mul Q-lane call: ``torch.bmm`` of
        the dense operator with the Q lanes as columns."""
        xcol = xin.reshape(Q, xin.shape[1], -1).permute(1, 2, 0)
        xcol = xcol.expand(P, -1, -1)
        return lambda: torch.bmm(a, xcol).permute(2, 0, 1)

    controls = []

    def must_fail(what, fn):
        try:
            fn()
        except SmokeFailure as e:
            controls.append({"control": what, "failed": True,
                             "message": str(e)[:160]})
            return
        raise SmokeFailure(f"wrong control passed: {what}")

    q_states = {}
    for sr, x, tl, btl in (
            (MIN_PLUS, x_mp, keep["sssp_tiles"], keep["sssp_btiles"]),
            (PLUS_MUL, x_pm, keep["pr_tiles"], keep["pr_btiles"])):
        if sr is PLUS_MUL:
            a_loc = dense_operator(tl, rows, cols, nvb, nvb)
            a_bnd = dense_operator(btl, brows, bcols, nvb, nbb)
        for Q in QUERY_SWEEP:
            xq = lanes_of(x, Q, sr)
            bq = _publish(xq, dg_like, sr, eng.comm)  # (Q, NB)
            q_states[(sr.name, Q)] = (xq, bq)
            xin_b = bq.reshape(Q, 1, -1)
            sfx = f" {sr.name} Q={Q}"
            # spmv: local sweep and consume
            for name, tt, rr, cc, xin, pl, n_t, a in (
                    ("local sweep", tl, rows, cols, xq, plan, n_local,
                     None if sr is MIN_PLUS else a_loc),
                    ("consume", btl, brows, bcols, xin_b, bplan, n_bound,
                     None if sr is MIN_PLUS else a_bnd)):
                lfn = None if a is None else bmm_lanes(a, xin, Q)
                moved = (n_t * tile_b + nbytes(rr, cc, xin)
                         + Q * P * Vp * 4)
                record("spmv_blocked_cuda", name + sfx, sr,
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, pl=pl:
                       spmv_blocked_cuda(tt, rr, cc, xin, sr,
                                         n_out_blocks=nvb, plan=pl),
                       lambda tt=tt, rr=rr, cc=cc, xin=xin:
                       spmv_blocked_ref(tt, rr, cc, xin, sr,
                                        n_out_blocks=nvb),
                       lfn, moved, n_t * B * B * Q, lanes=Q)
            # fused: the engine's shapes (SSSP: combine and vote; PageRank:
            # neither)
            xs4 = xq.reshape(Q, P, nvb, B)
            b4 = bq.reshape(Q, 1, nbb, B)
            vm3 = vmask.reshape(P, nvb, B)
            if sr is MIN_PLUS:
                fshapes = {"sweep": (tl, rows, cols, xs4, xs4, xs4, plan),
                           "consume": (btl, brows, bcols, b4, xs4,
                                       torch.flip(xs4, (3,)).contiguous(),
                                       bplan)}
            else:
                fshapes = {"spmv": (tl, rows, cols, xs4, None, None, plan),
                           "consume": (btl, brows, bcols, b4, None, None,
                                       bplan)}
            for name, (tt, rr, cc, xin, comb, xref, pl) in fshapes.items():
                n_t = n_local if tt is tl else n_bound
                vm = None if xref is None else vm3
                states = nbytes(xs4) + sum(
                    nbytes(t_) for t_ in (comb, xref, vm) if t_ is not None
                ) + (Q * P * 4 if xref is not None else 0)
                lfn = None if sr is MIN_PLUS else bmm_lanes(
                    a_loc if tt is tl else a_bnd, xin, Q)
                record("fused_step_cuda", name + sfx, sr,
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm, pl=pl: fused_step_cuda(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb, plan=pl),
                       lambda tt=tt, rr=rr, cc=cc, xin=xin, comb=comb,
                       xref=xref, vm=vm: fused_step_ref(
                           tt, rr, cc, xin, comb, xref, vm, sr,
                           n_out_blocks=nvb),
                       lfn, n_t * tile_b + nbytes(rr, cc, xin) + states,
                       n_t * B * B * Q, lanes=Q)

    # skewed control at Q = 32 (min-plus): the boundary runs of partition
    # 0 in one output block
    Q = QUERY_SWEEP[-1]
    btl = keep["sssp_btiles"]
    xq, bq = q_states[("min_plus", Q)]
    xs4, b4 = xq.reshape(Q, P, nvb, B), bq.reshape(Q, 1, nbb, B)
    xref4 = torch.flip(xs4, (3,)).contiguous()
    vm3 = vmask.reshape(P, nvb, B)
    name = f"consume min_plus Q={Q}, skewed control (partition 0 in one block)"
    record("spmv_blocked_cuda", name, MIN_PLUS,
           lambda: spmv_blocked_cuda(btl, brows, skew, bq[:, None], MIN_PLUS,
                                     n_out_blocks=nvb, plan=splan),
           lambda: spmv_blocked_ref(btl, brows, skew, bq[:, None], MIN_PLUS,
                                    n_out_blocks=nvb),
           None, n_bound * tile_b + nbytes(brows, skew, bq) + Q * P * Vp * 4,
           n_bound * B * B * Q, lanes=Q)
    record("fused_step_cuda", name, MIN_PLUS,
           lambda: fused_step_cuda(btl, brows, skew, b4, xs4, xref4, vm3,
                                   MIN_PLUS, plan=splan),
           lambda: fused_step_ref(btl, brows, skew, b4, xs4, xref4, vm3,
                                  MIN_PLUS),
           None, n_bound * tile_b + nbytes(brows, skew, b4, xs4, xs4, xref4,
                                           vm3) + Q * P * 4,
           n_bound * B * B * Q, lanes=Q)

    # signed zeros, infinities and NaN through the lane walk (min-plus,
    # Q = 20 and 32, the main path's local sweep and consume): tiles with
    # a third of their weights +0 or -0, one -inf and one NaN weight;
    # lanes of signed zeros, lanes with NaN and lanes with -inf; held
    # against the plain version (same_bits) and, lane by lane, against
    # the one-lane kernel (bit for bit, NaN included)
    sgen = torch.Generator(device=x_mp.device).manual_seed(19)

    def signed_zero_tiles(t):
        t = t.clone()
        pick = torch.isfinite(t) & (torch.rand(t.shape, generator=sgen,
                                               device=t.device) < 0.33)
        sign = torch.rand(t.shape, generator=sgen, device=t.device) < 0.5
        t[pick] = torch.where(sign, -0.0, 0.0)[pick]
        nz = torch.nonzero(torch.isfinite(t[0]))
        t[0][tuple(nz[0])] = float("-inf")
        t[0][tuple(nz[-1])] = float("nan")
        return t

    def special_lanes(x):
        x = x.clone()
        sign = torch.rand(x[1::4].shape, generator=sgen,
                          device=x.device) < 0.5
        x[1::4] = torch.where(sign, -0.0, 0.0)
        x[2::4, ..., 3::7] = float("nan")
        x[3::4, ..., 5::11] = float("-inf")
        return x

    ztl = signed_zero_tiles(keep["sssp_tiles"])
    zbtl = signed_zero_tiles(keep["sssp_btiles"])
    special = []
    for Q in (20, QUERY_SWEEP[-1]):
        xq, bq = q_states[("min_plus", Q)]
        xq, bq = special_lanes(xq), special_lanes(bq)
        xs4, b4 = xq.reshape(Q, P, nvb, B), bq.reshape(Q, 1, nbb, B)
        xref4 = torch.flip(xs4, (3,)).contiguous()
        vm3 = vmask.reshape(P, nvb, B)
        n0 = walk_counts()
        for name, kfn, pfn, one in (
                ("local sweep",
                 lambda: spmv_blocked_cuda(ztl, rows, cols, xq, MIN_PLUS,
                                           plan=plan),
                 lambda: spmv_blocked_ref(ztl, rows, cols, xq, MIN_PLUS),
                 lambda q: spmv_blocked_cuda(ztl, rows, cols, xq[q],
                                             MIN_PLUS, plan=plan)),
                ("consume",
                 lambda: fused_step_cuda(zbtl, brows, bcols, b4, xs4, xref4,
                                         vm3, MIN_PLUS, plan=bplan),
                 lambda: fused_step_ref(zbtl, brows, bcols, b4, xs4, xref4,
                                        vm3, MIN_PLUS),
                 lambda q: fused_step_cuda(zbtl, brows, bcols, b4[q], xs4[q],
                                           xref4[q], vm3, MIN_PLUS,
                                           plan=bplan))):
            what = f"{name} min_plus Q={Q}, ±0/±inf/NaN control"
            k, p_ = kfn(), pfn()
            if isinstance(k, tuple):
                need(torch.equal(k[1], p_[1]), f"{what}: votes differ")
                k, p_ = k[0], p_[0]
            same_bits(k, p_, what)
            lanes_checked = sorted({0, 1, 2, 3, Q - 1})
            for q in lanes_checked:
                o = one(q)
                o = o[0] if isinstance(o, tuple) else o
                need(torch.equal(k[q].view(torch.int32),
                                 o.view(torch.int32)),
                     f"{what}: lane {q} differs from the one-lane kernel")
            special.append({"control": what, "passed": True,
                            "signed_zero_outputs": int(
                                ((p_ == 0) & torch.signbit(p_)).sum()),
                            "nan_outputs": int(torch.isnan(p_).sum()),
                            "lanes_vs_one_lane": lanes_checked})
        by_walk = {kk: v["lane_walk"] - n0[kk]["lane_walk"]
                   for kk, v in walk_counts().items()}
        need(by_walk == {"spmv_blocked_cuda": 1, "fused_step_cuda": 1},
             f"signed-zero controls at Q={Q}: lane-walk launches {by_walk}")
    # the two-tile control: one output block, x = -0 at both tiles' rows,
    # weights +0 in one tile and -0 in the other, both orders, chunks of
    # one tile (the two meet in the run's combine): -0 at every output on
    # every walk
    for Q in (1, 4, 8, QUERY_SWEEP[-1]):
        for rev in (False, True):
            tt = torch.stack([torch.zeros(B, B), torch.full((B, B), -0.0)])
            rr = torch.tensor([0, 1], dtype=torch.int32)
            if rev:
                tt, rr = tt.flip(0), rr.flip(0)
            tt, rr = tt[None].contiguous().cuda(), rr[None].contiguous().cuda()
            cc = torch.zeros_like(rr)
            tplan = to_device(walk_plan(cc.cpu().numpy(), 1, chunk=1), "cuda")
            xz = torch.full((Q, 1, 2 * B), -0.0, device="cuda")
            y = spmv_blocked_cuda(tt, rr, cc, xz, MIN_PLUS, n_out_blocks=1,
                                  plan=tplan)
            need(bool(((y == 0) & torch.signbit(y)).all()),
                 f"two-tile ±0 control Q={Q} reverse={rev}: not -0")
    special.append({"control": "two-tile ±0, Q 1, 4, 8, 32, both orders",
                    "passed": True})
    # the plain folds on the card: MIN_PLUS.add is torch's CUDA minimum,
    # its reductions repaired; -0 wherever a -0 meets +0, both orders
    for n in (2, 100000):
        zz = torch.zeros(n, device="cuda")
        zz[n // 2:] = -0.0
        for t in (zz, zz.flip(0)):
            outs = (MIN_PLUS.add(t[:1].expand(n), t), MIN_PLUS.add(t, t.flip(0)),
                    MIN_PLUS.add_reduce(t, 0), MIN_PLUS.segment_reduce(
                        t, torch.zeros(n, dtype=torch.long, device="cuda"), 1),
                    MIN_PLUS.scatter_add(
                        torch.full((1,), float("inf"), device="cuda"),
                        torch.zeros(n, dtype=torch.long, device="cuda"), t))
            need(all(bool((o == 0).all()) for o in outs)
                 and bool(torch.signbit(outs[1]).all())
                 and all(bool(torch.signbit(o).all()) for o in outs[2:]),
                 f"MIN_PLUS folds on the card: a -0 lost (n={n})")
    special.append({"control": "MIN_PLUS add, add_reduce, segment_reduce, "
                    "scatter_add on the card, ±0 both orders",
                    "passed": True})
    print("signed-zero controls: " + json.dumps(special))

    # wrong controls: the Q-lane outputs against the plain version's with
    # the lanes rolled by one, and (plus-mul) with one tile dropped
    for sr, tl in ((MIN_PLUS, keep["sssp_tiles"]), (PLUS_MUL,
                                                   keep["pr_tiles"])):
        xq, _ = q_states[(sr.name, Q)]
        k = spmv_blocked_cuda(tl, rows, cols, xq, sr, plan=plan)
        p_ = spmv_blocked_ref(tl, rows, cols, xq, sr)
        compare(k, p_, sr.name, "control baseline")
        must_fail(f"local sweep {sr.name} Q={Q}, lanes rolled by one",
                  lambda: compare(k, p_.roll(1, 0), sr.name, "rolled"))
        if sr is PLUS_MUL:
            t_ = int(torch.nonzero(cols[0] >= 0)[0])
            cut = tl.clone()
            cut[0, t_] = 0.0
            p_cut = spmv_blocked_ref(cut, rows, cols, xq, sr)
            must_fail(f"local sweep {sr.name} Q={Q}, one tile dropped",
                      lambda: compare(k, p_cut, sr.name, "tile dropped"))
    print("wrong controls: " + json.dumps(controls))

    meta = {
        "spmv_blocked_cuda": (
            "src/repro_torch/kernels/csrc/semiring_spmm.cu",
            "src/repro/kernels/semiring_spmm/kernel.py:80"),
        "fused_step_cuda": (
            "src/repro_torch/kernels/csrc/semiring_superstep.cu",
            "src/repro/kernels/semiring_superstep/kernel.py:142"),
    }
    out = []
    for kernel, recs in calls.items():
        hot = recs[0]  # min-plus local sweep
        pm = [r for r in recs if r["library_ms"] is not None]
        out.append({
            "name": kernel, "route": "cuda", "source": meta[kernel][0],
            "replaces": meta[kernel][1], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "limit_used": max(r["limit_used"] for r in recs),
            "ms": hot["ms"], "eager_ms": hot["eager_ms"],
            "plain_ms": hot["plain_ms"],
            "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
            "library_ms": hot["library_ms"], "hot_call": hot["call"],
            "bound_share": hot["bound_share"],
            # the plus-mul calls, which have a library yardstick
            "plus_mul": {r["call"]: {k: r[k] for k in (
                "ms", "library_ms", "bound_ms", "bound_share")} for r in pm},
            # the Q = 32 calls of the query axis, launches on the query
            # path
            "q_lanes": {r["call"]: {k: r[k] for k in (
                "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bytes_ms", "issue_ms", "bound_share",
                "launches", "walk")} for r in recs
                if r.get("lanes") == QUERY_SWEEP[-1]},
            "controls": controls, "signed_zero_controls": special,
            "calls": recs, "card": card,
        })
    return out


# ---------------------------------------------------------------------------
# LM serving (starcoder2-7b): the attention kernels
# ---------------------------------------------------------------------------

# bf16 dense tensor-core peak of the one card on record (H100 SXM data
# sheet), FLOP/s
BF16_RATE = 989e12
# tol of attn_limit: the reference tests' rtol (tests/test_kernels.py:150
# and :197).  A bf16 output rounded one ulp apart differs by at most 2^-7
# of its value, well inside 2e-2; the absolute part scales with each row
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, Sq, Skv, H, K, d, causal, window, q_offset, dtype): FLASH_SWEEP of
# tests/test_kernels.py:127-136, then ragged Sq/Skv tails, G = 9 with
# starcoder2's d, windows longer than the sequence, one query row, a
# prefill continuing a cache (q_offset > 0), then the MoE family's groups
# with no window: G = 6 (dbrx-132b) and G = 5 (llama4-maverick), then
# whisper-medium's non-causal MHA (G = 1, 16 heads, d 64) over 1,500
# frames (a ragged last block of 92 keys): the encoder, the cross prefill
# of a 224-token prompt and of whisper's 4-token start prompt
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0, "float32"),
    (1, 128, 128, 8, 8, 64, True, 0, 0, "float32"),
    (2, 32, 32, 4, 1, 16, False, 0, 0, "float32"),
    (1, 64, 64, 2, 2, 32, True, 24, 0, "float32"),
    (1, 32, 96, 4, 2, 32, True, 0, 64, "float32"),
    (1, 64, 64, 4, 2, 32, True, 0, 0, "bfloat16"),
    (1, 128, 128, 2, 2, 128, True, 0, 0, "float32"),
    (1, 50, 50, 9, 1, 32, True, 16, 0, "float32"),
    (2, 37, 81, 4, 2, 64, True, 200, 44, "float32"),
    (1, 129, 129, 4, 2, 128, True, 50, 0, "float32"),
    (1, 300, 300, 36, 4, 128, True, 128, 0, "bfloat16"),
    (2, 100, 612, 36, 4, 128, True, 256, 512, "bfloat16"),
    (1, 77, 130, 8, 2, 64, False, 0, 0, "bfloat16"),
    (3, 1, 33, 4, 1, 16, True, 8, 32, "bfloat16"),
    (1, 200, 200, 16, 1, 128, True, 5000, 0, "bfloat16"),
    (2, 300, 300, 48, 8, 128, True, 0, 0, "bfloat16"),
    (1, 257, 257, 40, 8, 128, True, 0, 0, "bfloat16"),
    (2, 1500, 1500, 16, 16, 64, False, 0, 0, "bfloat16"),
    (2, 224, 1500, 16, 16, 64, False, 0, 0, "bfloat16"),
    (3, 4, 1500, 16, 16, 64, False, 0, 0, "bfloat16"),
]
# (B, S, H, K, d, window, dtype): DECODE_SWEEP of tests/test_kernels.py:
# 178-183, then G = 9, G = 16, windows longer than the cache, caches
# long enough for many splits, the MoE family's G = 6 and G = 5 with no
# window, and whisper-medium's cross decode (G = 1, 16 heads, d 64, over
# 1,500 frames); every case has a sequence of length 1
DECODE_CASES = [
    (2, 128, 4, 2, 32, 0, "float32"),
    (1, 256, 8, 1, 64, 0, "float32"),
    (3, 128, 4, 4, 32, 48, "float32"),
    (2, 128, 8, 2, 64, 0, "bfloat16"),
    (3, 100, 9, 1, 128, 0, "float32"),
    (2, 77, 18, 2, 64, 500, "bfloat16"),
    (4, 300, 36, 4, 128, 64, "bfloat16"),
    (2, 1000, 16, 1, 128, 0, "bfloat16"),
    (1, 4096, 36, 4, 128, 0, "bfloat16"),
    (4, 5000, 36, 4, 128, 4096, "bfloat16"),
    (2, 3000, 36, 4, 128, 0, "float32"),
    (4, 3000, 48, 8, 128, 0, "bfloat16"),
    (4, 2100, 40, 8, 128, 0, "bfloat16"),
    (8, 1500, 16, 16, 64, 0, "bfloat16"),
]
# the serving run: starcoder2-7b at full width and depth
SERVE_ARCH, SERVE_REQUESTS, SERVE_BATCH = "starcoder2-7b", 4, 4
SERVE_PROMPT, SERVE_NEW = 8192, 32
PARITY_S = 8192  # teacher-forcing prompt, batch 1
# the flash route of the serving prefill and the decode route of the
# serving decode steps (bf16, d = 128)
SERVE_FLASH_ROUTE = "bf16_wgmma"
SERVE_DECODE_ROUTE = "bf16_ring"
PARITY_TOL, PARITY_MARGIN = 5e-2, 2e-2  # tests/test_arch_smoke.py:103-109


def attn_limit(ref, tol):
    """Elementwise limit on |kernel - plain| for attention outputs (last
    dim the head dim): ``tol * (|ref| + min(1, 2 * row mean |ref|))``, a
    row being one query's output of one head.  The rounding of ``p`` and
    of the output scales with the row's magnitude: of order 1 where a row
    sees a few keys (the sweep's short sequences, where this is at most
    the reference tests' rtol = atol = ``tol``), near 0.03 where it sees
    thousands (the main path's).  A fixed atol of 2e-2 would pass a kernel
    that drops a key block there; the controls of :func:`attn_controls`
    show that such defects fail this limit."""
    a = ref.abs()
    return tol * (a + (2.0 * a.mean(dim=-1, keepdim=True)).clamp(max=1.0))


def attn_compare(kern, plain, tol: float, what: str):
    """Hold an attention kernel's output against its plain version within
    :func:`attn_limit`.  Returns (max abs error, largest share of the limit
    that any entry used, mean |plain|, max |plain|)."""
    import torch

    k, p = kern.float(), plain.float()
    need(k.shape == p.shape, f"{what}: shape {tuple(k.shape)} vs "
                             f"{tuple(p.shape)}")
    need(bool(torch.isfinite(k).all()), f"{what}: non-finite output")
    err = (k - p).abs()
    used = float((err / attn_limit(p, tol)).max())
    need(used <= 1.0, f"{what}: max abs error {float(err.max())} is "
                      f"{used:.3g}x the limit of attn_limit (tol {tol})")
    return float(err.max()), used, float(p.abs().mean()), float(p.abs().max())


def attn_controls(plain_out, controls, tol: float, what: str):
    """Deliberately wrong outputs (the plain version with the window edge
    one key off, the window's first 32-key block dropped, the causal edge
    one key off or the newest key lost) must each exceed :func:`attn_limit`: proof that the check sees
    such defects at this shape.  Returns {control: share of the limit}."""
    import torch

    lim = attn_limit(plain_out.float(), tol)
    out = {}
    for name, fn in controls.items():
        used = float(((fn().float() - plain_out.float()).abs() / lim).max())
        need(used > 1.0, f"{what}: the control '{name}' stays within the "
                         f"limit ({used:.3g}x); the check is too weak here")
        out[name] = used
    torch.cuda.empty_cache()
    return out


SWEEP_KEYS = ("max_abs_err", "limit_used", "mean_abs_plain", "max_abs_plain")


def attention_sweep(device="cuda", seed=1, log=print):
    """Both attention kernels against their plain versions on every case
    of FLASH_CASES and DECODE_CASES.  K/V are slices of a longer buffer,
    strided as the KV cache is.  Returns the number of comparisons."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dt))

    n = 0
    for case in FLASH_CASES:
        B, Sq, Skv, H, K, d, causal, window, qoff, dt = case
        q = randn(B, Sq, H, d, dt=dt)
        k = randn(B, Skv + 5, K, d, dt=dt)[:, :Skv]
        v = randn(B, Skv + 5, K, d, dt=dt)[:, :Skv]
        kw = dict(causal=causal, window=window, q_offset=qoff)
        got = attn_compare(flash_attention_cuda(q, k, v, **kw),
                           mha_ref(q, k, v, **kw), ATTN_TOL[dt],
                           f"flash {case}")
        log(f"  flash {case}: " + json.dumps(dict(zip(SWEEP_KEYS, got))))
        n += 1
    for case in DECODE_CASES:
        B, S, H, K, d, window, dt = case
        q = randn(B, H, d, dt=dt)
        k = randn(B, S + 3, K, d, dt=dt)[:, :S]
        v = randn(B, S + 3, K, d, dt=dt)[:, :S]
        lens = rng.integers(1, S + 1, B).astype(np.int32)
        lens[0] = 1
        lens[-1] = S if B > 1 else lens[-1]
        lt = torch.as_tensor(lens, device=device)
        got = attn_compare(decode_attention_cuda(q, k, v, lt, window=window),
                           decode_ref(q, k, v, lt, window=window),
                           ATTN_TOL[dt], f"decode {case} lengths "
                                         f"{lens.tolist()}")
        log(f"  decode {case}: " + json.dumps(dict(zip(SWEEP_KEYS, got))))
        n += 1
    torch.cuda.synchronize()
    return n


def attn_counters():
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    return flash_attention_cuda, decode_attention_cuda


def reset_attn_launches():
    """The attention kernels' launch counts (flash, decode and the flash
    backward), in total and by route, to 0."""
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import bwd
    from repro_torch.kernels.flash_attention import kernel as flash

    flash.reset_launches()
    decode.reset_launches()
    bwd.reset_launches()


@contextlib.contextmanager
def capture_layer0():
    """While the serving path runs, record what the attention kernels are
    given at their first call of each kind: layer 0 of the prefill and of
    the first decode step (lengths copied, since the cache's grow in
    place)."""
    from repro_torch.models import attention

    got = {}
    flash, decode = attention.flash_attention_cuda, attention.decode_attention_cuda

    def flash_rec(q, k, v, **kw):
        got.setdefault("flash", (q, k, v, kw["window"], kw["q_offset"]))
        return flash(q, k, v, **kw)

    def decode_rec(q, k, v, lengths, **kw):
        got.setdefault("decode", (q, k, v, lengths.clone(), kw["window"]))
        return decode(q, k, v, lengths, **kw)

    attention.flash_attention_cuda = flash_rec
    attention.decode_attention_cuda = decode_rec
    try:
        yield got
    finally:
        attention.flash_attention_cuda = flash
        attention.decode_attention_cuda = decode


def serve_path(device="cuda", log=print):
    """The LM main path: starcoder2-7b at full width and depth, random
    weights from a seeded generator on the card, ``BatchedServer``
    answering SERVE_REQUESTS prompts of SERVE_PROMPT tokens with SERVE_NEW
    new tokens each, at batch SERVE_BATCH.  A second run must give the
    same tokens.  Returns what the later phases need."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_model_params

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase serve_init: {json.dumps({'seconds': time.perf_counter() - t0, 'arch': cfg.name, 'layers': cfg.num_layers, 'd_model': cfg.d_model, 'params': n_params, 'weights_GB': torch.cuda.memory_allocated() / 1e9})}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]

    def run():
        srv = BatchedServer(model, batch_size=SERVE_BATCH,
                            max_len=SERVE_PROMPT + SERVE_NEW + 8)
        done = srv.serve([Request(rid=i, tokens=p, max_new=SERVE_NEW)
                          for i, p in enumerate(prompts)])
        return srv, [r.out for r in done]

    flash, decode = attn_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    with capture_layer0() as shapes:
        srv, outs = run()
    launches = {"flash_attention_cuda": flash.launches,
                "decode_attention_cuda": decode.launches}
    routes = {"flash_attention_cuda": dict(flash.launches_by_route),
              "decode_attention_cuda": dict(decode.launches_by_route)}
    flash_routes = routes["flash_attention_cuda"]
    decode_routes = routes["decode_attention_cuda"]
    st = srv.stats
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "tokens": st["tokens"],
           "tokens_per_s": st["tokens"] / (st["prefill_s"] + st["decode_s"]),
           "decode_tokens_per_s": SERVE_REQUESTS * (SERVE_NEW - 1)
           / st["decode_s"],
           "prompt_tokens_per_s": SERVE_REQUESTS * SERVE_PROMPT
           / st["prefill_s"], "peak_GB": peak, "launches": launches,
           "flash_launches_by_route": flash_routes,
           "decode_launches_by_route": decode_routes}
    log(f"phase serve: {json.dumps(rec)}")
    need(len(outs) == SERVE_REQUESTS, "serve: requests lost")
    need(all(len(o) == SERVE_NEW for o in outs), "serve: token counts")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o),
         "serve: a padded vocab entry won")
    need(st["finite"], "serve: non-finite logits")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the serving path")
    need(flash_routes[SERVE_FLASH_ROUTE] == launches["flash_attention_cuda"]
         == cfg.num_layers, f"serve: the prefill's flash launches took the "
                            f"routes {flash_routes}, not all "
                            f"{cfg.num_layers} {SERVE_FLASH_ROUTE}")
    n_decode = cfg.num_layers * (SERVE_NEW - 1) * -(-SERVE_REQUESTS
                                                   // SERVE_BATCH)
    need(decode_routes[SERVE_DECODE_ROUTE] == launches["decode_attention_cuda"]
         == n_decode, f"serve: the decode launches took the routes "
                      f"{decode_routes}, not all {n_decode} "
                      f"{SERVE_DECODE_ROUTE}")
    srv2, outs2 = run()
    need(outs2 == outs, "serve: a second run gave other tokens")
    log(f"phase serve_repeat: {json.dumps({'prefill_s': srv2.stats['prefill_s'], 'decode_s': srv2.stats['decode_s'], 'identical_tokens': True})}")
    log(f"  first tokens: {[o[:8] for o in outs]}")
    return {"cfg": cfg, "model": model, "prompts": prompts, "outs": outs,
            "launches": launches, "routes": routes, "serve": rec,
            "shapes": shapes}


def profile_window(name, fn, log=print, top=12, phase="serve_profile"):
    """``torch.profiler`` over one call of ``fn``: the host wall time, the
    device time the profiler saw (the sum of the kernels' own times), the
    device's idle share of the wall time, the kernels that took the most
    device time, every attention kernel of the port, and the peak device
    memory allocated since the caller last reset it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sync():  # a CPU rehearsal runs the window with no card
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, copies): the host ops that
    # launched them carry the same time again
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    rec = {"wall_ms": wall * 1e3, "device_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
           "device_launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "calls": n, "name": k[:90]}
                   for ms, n, k in rows[:top]],
           "attention": [{"ms": ms, "calls": n, "name": k[:90]}
                         for ms, n, k in rows if "attn_" in k]}
    if torch.cuda.is_initialized():
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase {phase} {name}: {json.dumps(rec)}")
    if not busy:
        log("  the profiler saw no device time")
    return rec


def serve_profile(lm, device="cuda", log=print, n_decode=4, top=12,
                  phase="serve_profile"):
    """Where the serving time goes: ``torch.profiler`` over one prefill of
    the SERVE_BATCH prompts and over ``n_decode`` decode steps.  Prints,
    for each window, the host wall time, the device time the profiler saw
    (the sum of the kernels' own times), the device's idle share of the
    wall time, the kernels that took the most device time, and every
    attention kernel of the port (a decode call's split kernel and its
    combine launch, which the top rows may leave out)."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_serve_cache, prefill

    cfg, model = lm["cfg"], lm["model"]
    B, S = SERVE_BATCH, SERVE_PROMPT
    toks = np.stack(lm["prompts"][:B])
    nxt = np.array([[o[0]] for o in lm["outs"][:B]], np.int32)
    cache = init_serve_cache(cfg, B, S + n_decode + 8, device=device)
    out = {}

    def window(name, fn):
        out[name] = profile_window(name, fn, log, top, phase)

    def run_prefill():
        nonlocal cache
        _, cache = prefill(model, {"tokens": toks, "cache": cache})

    def run_decode():
        nonlocal cache
        for i in range(n_decode):
            _, cache = decode_step(model, {
                "tokens": nxt, "pos": np.full(B, S + i, np.int32),
                "cache": cache})

    window("prefill", run_prefill)
    window(f"decode x{n_decode}", run_decode)
    del cache
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def parity_run(model, cfg, S, device="cuda", extra=None):
    """Prefilling S + 1 tokens and prefilling S then decoding one must give
    the same last-token logits (tests/test_arch_smoke.py:67-109): the
    flash kernel against the decode kernel over all layers, within
    PARITY_TOL, and the same top-1 where the top-2 margin exceeds
    PARITY_MARGIN.  ``extra`` goes to both prefills (the audio family's
    ``frames``).  Returns the record."""
    import numpy as np

    from repro_torch.models import decode_step, init_serve_cache, prefill

    V = cfg.vocab_size
    toks = np.random.default_rng(1).integers(0, V, (1, S + 1)).astype(
        np.int32)
    t0 = time.perf_counter()
    extra = extra or {}
    cache = init_serve_cache(cfg, 1, S + 9, device=device)
    la, _ = prefill(model, {"tokens": toks, "cache": cache, **extra})
    cache = init_serve_cache(cfg, 1, S + 9, device=device)
    _, cache = prefill(model, {"tokens": toks[:, :S], "cache": cache,
                               **extra})
    lb, _ = decode_step(model, {"tokens": toks[:, S:],
                                "pos": np.array([S], np.int32),
                                "cache": cache})
    del cache
    va = la[:, -1, :V].float().cpu().numpy()
    vb = lb[:, -1, :V].float().cpu().numpy()
    need(np.isfinite(va).all() and np.isfinite(vb).all(),
         f"teacher forcing {cfg.name}: non-finite logits")
    err = float(np.abs(va - vb).max())
    need(np.allclose(va, vb, rtol=PARITY_TOL, atol=PARITY_TOL),
         f"teacher forcing {cfg.name}: logits differ by {err} beyond "
         f"{PARITY_TOL}")
    top2 = np.sort(va[0])[-2:]
    margin = float(top2[1] - top2[0])
    if margin > PARITY_MARGIN:
        need(va[0].argmax() == vb[0].argmax(),
             f"teacher forcing {cfg.name}: top-1 differs")
    return {"seconds": time.perf_counter() - t0, "S": S,
            "max_abs_err": err, "logit_std": float(va.std()),
            "top2_margin": margin,
            "top1_equal": bool(va[0].argmax() == vb[0].argmax())}


def teacher_forcing(lm, device="cuda", log=print):
    """:func:`parity_run` of the serving model at PARITY_S."""
    import torch

    rec = parity_run(lm["model"], lm["cfg"], PARITY_S, device)
    log(f"phase teacher_forcing: {json.dumps(rec)}")
    torch.cuda.empty_cache()
    return rec["max_abs_err"]


# ---------------------------------------------------------------------------
# phase 8b: the MoE family serving (dbrx-132b, llama4-maverick-400b-a17b)
# ---------------------------------------------------------------------------

# (arch, layers kept of its published depth): full width, random weights,
# cut in depth only.  dbrx: 4 of 40 MoE layers (16 experts, top 4;
# 14.27B parameters); llama4: 1 group of 24, one dense and one MoE layer
# (128 experts, top 1, the shared expert; 16.48B body parameters)
MOE_CUTS = (("dbrx-132b", 4), ("llama4-maverick-400b-a17b", 2))
# teacher forcing on a copy of the config that drops nothing (the
# reference's own test, tests/test_arch_smoke.py:74-80): capacity drops
# depend on the batch, a lone decode token never drops.  Prompt length:
# dbrx's capacity at factor 64 is 16 T slots an expert (T = S + 1)
MOE_NODROP_CF, MOE_PARITY_S = 64.0, 1024
# the dispatch check: tokens through one MoE layer, a capacity factor
# that drops (C = 8, the floor), and the dropping run's input: this many
# distinct tokens, each repeated, so that every expert chosen gets more
# entries than C whatever the routing
MOE_CHECK_T, MOE_DROP_CF, MOE_DROP_DISTINCT = 256, 0.05, 16


def moe_cut_configs():
    """The MoE configs the phase serves, cut in depth (MOE_CUTS)."""
    from repro_torch.configs import get_config

    return [get_config(a).with_overrides(num_layers=n) for a, n in MOE_CUTS]


def schema_params(cfg) -> int:
    """Parameters of ``cfg``'s schema: ``param_count()`` plus what it
    leaves out, the padded vocabulary rows of embed and head and the
    LayerNorm biases."""
    n = cfg.param_count()
    n += ((cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
          * (1 if cfg.tie_embeddings else 2))
    if cfg.norm == "layernorm":
        n += (2 * cfg.num_layers + 1) * cfg.d_model
    return n


@contextlib.contextmanager
def moe_patched(name, fn):
    """One function of the MoE module replaced while the block runs
    (``moe_apply_local`` looks its stages up in the module at each call)."""
    from repro_torch.models import moe

    orig = getattr(moe, name)
    setattr(moe, name, fn)
    try:
        yield
    finally:
        setattr(moe, name, orig)


@contextlib.contextmanager
def moe_dispatches():
    """While a MoE path runs, record every dispatch: (tokens, the (T, k)
    keep mask)."""
    from repro_torch.models import moe

    got = []

    def rec(x, top_g, top_i, num_experts, capacity):
        out = orig(x, top_g, top_i, num_experts, capacity)
        got.append((x.shape[0], out[2]))
        return out

    orig = moe._dispatch
    with moe_patched("_dispatch", rec):
        yield got


def route_no_renorm(p, x, cfg):
    """Wrong control: the top-k gates left as softmax probabilities."""
    import torch

    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    return top_g[:, :k], top_i[:, :k].to(torch.int32), gates


def dispatch_by_assignment(x, top_g, top_i, num_experts, capacity):
    """Wrong control: the entries written by assignment in flattened
    order, a dropped one as ``x * 0`` at slot C - 1, so that it overwrites
    the token kept there (the reference adds it).  Every dropped entry of
    an expert comes after the one kept at C - 1, so the kept entries are
    written first and the dropped ones over them."""
    import torch
    import torch.nn.functional as F

    T, k = top_i.shape
    E, C = num_experts, capacity
    flat_e = top_i.reshape(-1).long()
    onehot = F.one_hot(flat_e, E)
    slot = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    kept = slot < C
    slot = slot.clamp_max(C - 1)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((E, C, x.shape[-1]))
    buf[flat_e[kept], slot[kept]] = x[tok[kept]]
    buf[flat_e[~kept], slot[~kept]] = 0
    return (buf, slot.reshape(T, k), kept.to(x.dtype).reshape(T, k), tok)


def moe_token_loop(p, x, cfg):
    """The plain version of one MoE layer, token by token: for each token,
    the sum over its kept choices of gate times that expert's MLP, plus
    the shared expert.  Gates from the float32 softmax of the router; the
    top k by a stable sort on the host; each gate renormalised by its
    row's sum; the kept set by the first-come rule recomputed on the host
    (an entry is kept while fewer than C earlier entries, in (token,
    choice) order, chose its expert).  The weights cast to x's type (the
    layer casts its masters so), the products in x's type, the sum in
    float32 (float64 for float64 x); the experts' MLPs SwiGLU, as
    in both MoE configs.  Differentiable in x and every weight (the host
    decides only which entries count).  Returns (output (T, d) in x's
    type, the number of dropped entries)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    need(cfg.mlp_activation == "swiglu", f"moe {cfg.name}: the token loop "
                                         f"computes SwiGLU experts")
    T, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gates = torch.softmax(x.float() @ p["router"].float(), -1)
    order = np.argsort(-gates.detach().cpu().numpy(), axis=1,
                       kind="stable")[:, :k]
    g = gates.gather(1, torch.as_tensor(order, device=x.device))
    g = g / g.sum(1, keepdim=True).clamp_min(1e-9)
    c = int(T * k * cfg.moe.capacity_factor / E)
    C = max(8, -(-c // 8) * 8)
    count = np.zeros(E, np.int64)
    kept = np.zeros((T, k), bool)
    for t in range(T):
        for j in range(k):
            kept[t, j] = count[order[t, j]] < C
            count[order[t, j]] += 1

    experts = {}

    def expert(e):
        if e not in experts:
            experts[e] = (p["wi"][e].to(x.dtype), p["wo"][e].to(x.dtype))
        return experts[e]

    def mlp(wi, wo, xt):
        a, u = (xt @ wi).chunk(2, dim=-1)
        return (F.silu(a) * u) @ wo

    st = torch.promote_types(torch.float32, x.dtype)
    rows = []
    for t in range(T):
        acc = torch.zeros(d, dtype=st, device=x.device)
        for j in range(k):
            if kept[t, j]:
                acc = acc + g[t, j] * mlp(*expert(int(order[t, j])),
                                          x[t:t + 1])[0].to(st)
        rows.append(acc)
    out = torch.stack(rows)
    if cfg.moe.shared_expert:
        out = out + mlp(p["shared_wi"].to(x.dtype),
                        p["shared_wo"].to(x.dtype), x).to(st)
    return out.to(x.dtype), int((~kept).sum())


def moe_limit_used(got, plain, tol) -> float:
    """The largest share of :func:`attn_limit` (per token row) that any
    entry of ``got`` uses against ``plain``.  A token whose every choice
    was dropped (no shared expert) has a zero row and a zero limit: there
    any difference counts as infinitely over."""
    import torch

    g, p = got.float(), plain.float()
    err = (g - p).abs()
    lim = attn_limit(p, tol)
    share = torch.where(lim > 0, err / lim.clamp_min(1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(share.max())


def moe_layer_check(model, cfg, gen, device="cuda", log=print):
    """``moe_apply_local`` on the model's first MoE layer at full width
    against :func:`moe_token_loop`, within :func:`attn_limit` (per token
    row, the bf16 tolerance): MOE_CHECK_T random tokens at the config's
    capacity, then at MOE_DROP_CF on MOE_DROP_DISTINCT tokens each
    repeated, where entries must drop.  Two wrong controls must exceed
    the limit: the gates not renormalised, and dropped entries written by
    assignment (at the dropping capacity).  Returns the records."""
    import dataclasses

    import torch

    from repro_torch.models import moe

    p = model.stacked_layers("moe")[0].moe
    dt = getattr(torch, cfg.dtype)
    tol = ATTN_TOL[cfg.dtype]
    x = torch.randn((MOE_CHECK_T, cfg.d_model), generator=gen,
                    device=device).to(dt)
    reps = MOE_CHECK_T // MOE_DROP_DISTINCT
    drop_cfg = cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DROP_CF))
    out = {}
    for name, c, xs in (("nominal", cfg, x),
                        ("dropping", drop_cfg,
                         x[:MOE_DROP_DISTINCT].repeat_interleave(reps, 0))):
        with moe_dispatches() as calls:
            got, _ = moe.moe_apply_local(p, xs[None], c)
        plain, dropped = moe_token_loop(p, xs, c)
        keep = calls[0][1]
        n_drop = int((keep == 0).sum())
        need(n_drop == dropped, f"moe {cfg.name} {name}: {n_drop} entries "
                                f"dropped, the host's rule drops {dropped}")
        need(got.shape == (1,) + plain.shape, f"moe {cfg.name} {name}: "
                                              f"shape {tuple(got.shape)}")
        need(bool(torch.isfinite(got).all()),
             f"moe {cfg.name} {name}: non-finite output")
        used = moe_limit_used(got[0], plain, tol)
        need(used <= 1.0, f"moe {cfg.name} {name}: {used:.3g}x the limit "
                          f"of attn_limit (tol {tol}) against the token loop")
        if name == "dropping":
            need(n_drop > 0, f"moe {cfg.name}: nothing dropped at capacity "
                             f"factor {MOE_DROP_CF}")
            control = ("dropped_by_assignment", "_dispatch",
                       dispatch_by_assignment)
        else:
            control = ("no_renormalisation", "_route", route_no_renorm)
        with moe_patched(*control[1:]):
            bad, _ = moe.moe_apply_local(p, xs[None], c)
        bad_used = moe_limit_used(bad[0], plain, tol)
        need(bad_used > 1.0, f"moe {cfg.name} {name}: the control "
                             f"'{control[0]}' stays within the limit "
                             f"({bad_used:.3g}x)")
        out[name] = {
            "tokens": xs.shape[0], "capacity": moe._capacity(xs.shape[0], c),
            "dropped": n_drop, "dropped_share": n_drop / keep.numel(),
            "max_abs_err": float((got[0].float() - plain.float()).abs().max()),
            "limit_used": used, "mean_abs_plain": float(plain.float().abs()
                                                        .mean()),
            "controls_limit_used": {control[0]: bad_used}}
    return out


def moe_teacher_forcing(model, cfg, device="cuda"):
    """:func:`parity_run` at MOE_PARITY_S on a no-drop copy of the config
    (capacity factor MOE_NODROP_CF), the model's own weights; no entry may
    drop.  Returns the record."""
    import dataclasses

    nodrop = cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_NODROP_CF))
    model.cfg = nodrop
    try:
        with moe_dispatches() as calls:
            rec = parity_run(model, nodrop, MOE_PARITY_S, device)
    finally:
        model.cfg = cfg
    dropped = sum(int((keep == 0).sum()) for _, keep in calls)
    need(dropped == 0, f"moe {cfg.name} teacher forcing: {dropped} entries "
                       f"dropped at capacity factor {MOE_NODROP_CF}")
    rec.update(capacity_factor=MOE_NODROP_CF, dispatches=len(calls))
    return rec


def wrong_kv_heads(fn, q, k, *args, **kw):
    """Wrong control: ``fn`` (a plain attention) with query head h reading
    KV head h % K in place of h // G, the grouping a kernel that mixed up
    its query groups would compute; under MHA (G = 1), where that is the
    right head, KV head (h + 1) % K.  Differs from the right grouping
    wherever K > 1."""
    H, d, K = q.shape[-2], q.shape[-1], k.shape[2]
    G, lead = H // K, q.shape[:-2]
    if G == 1:
        return fn(q.roll(1, dims=-2), k, *args, **kw).roll(-1, dims=-2)
    qq = q.reshape(*lead, G, K, d).transpose(-3, -2).reshape(*lead, H, d)
    out = fn(qq, k, *args, **kw)
    return out.reshape(*lead, K, G, d).transpose(-3, -2).reshape(*lead, H, d)


def moe_attention_check(shapes, cfg, log=print):
    """Kernels 3 and 4 at one MoE model's serving shapes, layer 0 of the
    prefill and of the first decode step as :func:`capture_layer0`
    recorded them (query groups of G = H / K; no window in either MoE
    config), against ``mha_ref`` and ``decode_ref`` within
    :func:`attn_limit` at the bf16 tolerance, on the same card tensors.
    Wrong controls that need no window must exceed the limit: the causal
    edge one key off (flash), the newest key lost and the oldest 32 keys
    dropped (decode), and, for both, the query heads read by the wrong KV
    heads (:func:`wrong_kv_heads`).  Returns {kernel: record}."""
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import mha_ref

    flash_k, decode_k = attn_counters()
    tol = ATTN_TOL["bfloat16"]
    out = {}

    def check(kernel, name, q, k, kfn, pfn, controls):
        H, K = q.shape[-2], k.shape[2]
        if H // K > 1 and K > 1:
            controls["query heads on the wrong KV heads"] = \
                lambda: wrong_kv_heads(pfn, q, k)
        kout, pout = kfn(q, k), pfn(q, k)
        err, used, mean_p, max_p = attn_compare(kout, pout, tol, name)
        ctl = attn_controls(pout, controls, tol, name)
        out[kernel] = {"call": name, "q": list(q.shape), "kv": list(k.shape),
                       "group": H // K, "max_abs_err": err,
                       "limit_used": used, "mean_abs_plain": mean_p,
                       "max_abs_plain": max_p, "controls_limit_used": ctl}

    q, k, v, window, q_offset = shapes["flash"]
    need(not window, f"moe {cfg.name}: the prefill ran with window {window}")
    kw = dict(causal=True, window=window, q_offset=q_offset)
    check("flash_attention_cuda", f"{cfg.name} serve prefill, layer 0", q, k,
          lambda q, k: flash_k(q, k, v, **kw),
          lambda q, k: mha_ref(q, k, v, **kw),
          {"causal edge one key off": lambda: mha_ref(
              q, k, v, causal=True, window=window, q_offset=q_offset - 1)})
    q, k, v, lengths, window = shapes["decode"]
    need(not window, f"moe {cfg.name}: decode ran with window {window}")
    lmin = int(lengths.min())
    drop = min(32, lmin // 2)
    need(drop > 0, f"moe {cfg.name}: decode lengths {lengths.tolist()}")
    check("decode_attention_cuda", f"{cfg.name} serve decode step 1, layer 0",
          q, k, lambda q, k: decode_k(q, k, v, lengths, window=window),
          lambda q, k: decode_ref(q, k, v, lengths, window=window),
          {"newest key lost": lambda: decode_ref(
              q, k, v, (lengths - 1).clamp(min=1), window=window),
           f"oldest {drop} keys dropped": lambda: decode_ref(
               q, k, v, lengths, window=lmin - drop)})
    out["decode_attention_cuda"]["lengths"] = lengths.tolist()
    return out


def moe_serve_one(cfg, card, device="cuda", log=print):
    """One MoE model at full width cut in depth: random weights from a
    seeded generator, ``BatchedServer`` answering SERVE_REQUESTS prompts
    of SERVE_PROMPT tokens with SERVE_NEW new tokens each at batch
    SERVE_BATCH, launches counted by route (every prefill launch of
    kernel 3 on SERVE_FLASH_ROUTE, every decode launch of kernel 4 on
    SERVE_DECODE_ROUTE, layers x prefills and layers x decode steps), a
    second serve giving the same tokens, the share of entries each MoE
    layer drops in the prefill, a profile of one prefill and four decode
    steps; kernels 3 and 4 at the serve's layer-0 shapes against their
    plain versions (:func:`moe_attention_check`); then teacher forcing and
    the dispatch check.  The model is freed before it returns."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_model_params, moe

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_model_params(cfg, gen, device)
    if on_card:
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    outside = (model.embed.numel() + sum(p.numel() for p in
                                         model.ln_f.values())
               + (0 if cfg.tie_embeddings else model.head.numel()))
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "kinds": [layer.kind for layer in model.layers],
           "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "shared_expert": cfg.moe.shared_expert,
           "params": n_params, "body_params": n_params - outside,
           "param_count": cfg.param_count(), "init_s":
           time.perf_counter() - t0, "card": card}
    if on_card:
        rec["weights_GB"] = torch.cuda.memory_allocated() / 1e9
    need(n_params == schema_params(cfg),
         f"moe {cfg.name}: {n_params} parameters, param_count() and the "
         f"padding and biases it leaves out give {schema_params(cfg)}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    flash, decode = attn_counters()

    def run():
        srv = BatchedServer(model, batch_size=SERVE_BATCH,
                            max_len=SERVE_PROMPT + SERVE_NEW + 8)
        done = srv.serve([Request(rid=i, tokens=p, max_new=SERVE_NEW)
                          for i, p in enumerate(prompts)])
        return srv, [r.out for r in done]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    with moe_dispatches() as calls, capture_layer0() as shapes:
        srv, outs = run()
    launches = {"flash_attention_cuda": flash.launches,
                "decode_attention_cuda": decode.launches}
    routes = {"flash_attention_cuda": dict(flash.launches_by_route),
              "decode_attention_cuda": dict(decode.launches_by_route)}
    st = srv.stats
    n_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    prefill_T = SERVE_BATCH * SERVE_PROMPT
    drops = [float((keep == 0).float().mean()) for T, keep in calls
             if T == prefill_T]
    n_moe = sum(layer.kind == "moe" for layer in model.layers)
    need(len(drops) == n_moe * n_batches,
         f"moe {cfg.name}: {len(drops)} prefill dispatches, not "
         f"{n_moe * n_batches}")
    rec.update({
        "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
        "tokens": st["tokens"],
        "tokens_per_s": st["tokens"] / (st["prefill_s"] + st["decode_s"]),
        "decode_tokens_per_s": SERVE_REQUESTS * (SERVE_NEW - 1)
        / st["decode_s"],
        "prompt_tokens_per_s": SERVE_REQUESTS * SERVE_PROMPT
        / st["prefill_s"],
        "prefill_capacity": moe._capacity(prefill_T, cfg),
        "prefill_dropped_share_by_moe_layer": drops,
        "launches": launches, "launches_by_route": routes})
    if on_card:
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    need(len(outs) == SERVE_REQUESTS, f"moe {cfg.name}: requests lost")
    need(all(len(o) == SERVE_NEW for o in outs),
         f"moe {cfg.name}: token counts")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o),
         f"moe {cfg.name}: a padded vocab entry won")
    need(st["finite"], f"moe {cfg.name}: non-finite logits")
    if on_card:
        n_flash = cfg.num_layers * n_batches
        n_decode = cfg.num_layers * (SERVE_NEW - 1) * n_batches
        fr = routes["flash_attention_cuda"]
        dr = routes["decode_attention_cuda"]
        need(fr.get(SERVE_FLASH_ROUTE) == launches["flash_attention_cuda"]
             == n_flash, f"moe {cfg.name}: the prefill's flash launches "
                         f"took the routes {fr}, not all {n_flash} "
                         f"{SERVE_FLASH_ROUTE}")
        need(dr.get(SERVE_DECODE_ROUTE) == launches["decode_attention_cuda"]
             == n_decode, f"moe {cfg.name}: the decode launches took the "
                          f"routes {dr}, not all {n_decode} "
                          f"{SERVE_DECODE_ROUTE}")
    rec["attention_check"] = moe_attention_check(shapes, cfg, log)
    log(f"phase moe_attention_check_{cfg.name}: "
        f"{json.dumps(rec['attention_check'])}")
    shapes.clear()
    srv2, outs2 = run()
    need(outs2 == outs, f"moe {cfg.name}: a second serve gave other tokens")
    rec["repeat"] = {"prefill_s": srv2.stats["prefill_s"],
                     "decode_s": srv2.stats["decode_s"],
                     "identical_tokens": True}
    rec["first_tokens"] = [o[:8] for o in outs]
    log(f"phase moe_serve_{cfg.name}: {json.dumps(rec)}")
    # where the serving time goes: one prefill of the batch, four decode
    # steps, under the profiler
    serve_profile({"cfg": cfg, "model": model, "prompts": prompts,
                   "outs": outs}, device, log,
                  phase=f"moe_serve_profile_{cfg.name}")
    rec["teacher_forcing"] = moe_teacher_forcing(model, cfg, device)
    log(f"phase moe_teacher_forcing_{cfg.name}: "
        f"{json.dumps(rec['teacher_forcing'])}")
    t1 = time.perf_counter()
    rec["layer_check"] = moe_layer_check(model, cfg, gen, device, log)
    rec["layer_check"]["seconds"] = time.perf_counter() - t1
    log(f"phase moe_layer_check_{cfg.name}: "
        f"{json.dumps(rec['layer_check'])}")
    del model, srv, srv2, calls
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def moe_serve(cfgs, card, device="cuda", log=print):
    """Phase 8b: each MoE config of ``cfgs`` through
    :func:`moe_serve_one`, one model on the card at a time.  Returns
    {arch: record}."""
    log(f"moe path cuts: {json.dumps({c.name: {'layers': c.num_layers, 'groups': c.num_layers // c.moe.moe_every, 'moe_every': c.moe.moe_every} for c in cfgs})} (full width; dbrx-132b has 40 layers, "
        f"llama4-maverick-400b-a17b 48)")
    return {c.name: moe_serve_one(c, card, device, log) for c in cfgs}


# ---------------------------------------------------------------------------
# phase 8c: the audio family serving (whisper-medium)
# ---------------------------------------------------------------------------

# whisper-medium at full width and depth (24 encoder and 24 decoder
# layers): 8 clips of 30 s (1,500 frames after the stub frontend), each
# with a 224-token prompt (whisper's long-form context, n_text_ctx // 2)
# and 64 new tokens (288 of its 448 positions), at batch 8
AUDIO_ARCH = "whisper-medium"
AUDIO_REQUESTS, AUDIO_BATCH = 8, 8
AUDIO_PROMPT, AUDIO_NEW = 224, 64
# the kernel-3 calls of one prefill, in order: the encoder's layers, then
# each decoder layer's self-attention and cross-attention; a decode step
# calls kernel 4 for each decoder layer's self- and cross-attention
AUDIO_CALLS = ("encoder", "self prefill", "cross prefill", "self decode",
               "cross decode")
# the score (q.k / sqrt(d)) of the key planted on each query for the
# cross decode's last-frame controls: near-uniform attention over 1,500
# frames gives one frame 1/1,500 of a row, below the bf16 limit, while a
# key scored 8 takes about 0.6 of it
AUDIO_PLANT_SCORE = 8.0


def schema_leaves(cfg) -> int:
    """Parameters of ``cfg``'s schema (``models.model_schema``), leaf by
    leaf."""
    import numpy as np

    from repro_torch.models import model_schema
    from repro_torch.models.layers import ParamDef

    def leaves(node):
        if isinstance(node, ParamDef):
            return int(np.prod(node.shape))
        return sum(leaves(v) for v in node.values())

    return leaves(model_schema(cfg))


@contextlib.contextmanager
def timed_encoder():
    """While the block runs, the device seconds of each ``encdec.encode``
    call (synchronised before and after), in the list yielded."""
    import torch

    from repro_torch.models import encdec

    secs, orig = [], encdec.encode

    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def timed(model, frames):
        sync()
        t0 = time.perf_counter()
        out = orig(model, frames)
        sync()
        secs.append(time.perf_counter() - t0)
        return out

    encdec.encode = timed
    try:
        yield secs
    finally:
        encdec.encode = orig


@contextlib.contextmanager
def capture_audio_calls(cfg):
    """While the audio serving path runs, record what the attention
    kernels are given at layer 0 of each kind of call (AUDIO_CALLS): the
    first prefill's kernel-3 calls 0 (the encoder), E and E + 1 (the
    decoder's self- and cross-attention, E encoder layers), and the first
    decode step's kernel-4 calls 0 and 1 (lengths copied)."""
    from repro_torch.models import attention

    got, n = {}, {"flash": 0, "decode": 0}
    flash, decode = attention.flash_attention_cuda, attention.decode_attention_cuda
    at = {0: "encoder", cfg.encoder_layers: "self prefill",
          cfg.encoder_layers + 1: "cross prefill"}

    def flash_rec(q, k, v, **kw):
        name = at.get(n["flash"])
        if name and name not in got:
            got[name] = (q, k, v, kw)
        n["flash"] += 1
        return flash(q, k, v, **kw)

    def decode_rec(q, k, v, lengths, **kw):
        name = {0: "self decode", 1: "cross decode"}.get(n["decode"])
        if name and name not in got:
            got[name] = (q, k, v, lengths.clone(), kw)
        n["decode"] += 1
        return decode(q, k, v, lengths, **kw)

    attention.flash_attention_cuda = flash_rec
    attention.decode_attention_cuda = decode_rec
    try:
        yield got
    finally:
        attention.flash_attention_cuda = flash
        attention.decode_attention_cuda = decode


def audio_calls(shapes, log=print):
    """Kernels 3 and 4 at the audio serve's layer-0 calls (AUDIO_CALLS, as
    :func:`capture_audio_calls` recorded them) against ``mha_ref`` and
    ``decode_ref`` within :func:`attn_limit` at the bf16 tolerance, on
    the same tensors.  Wrong controls must exceed the limit: the encoder
    run causal; the cross prefill with the keys of the last, ragged
    128-key block dropped; the self prefill's causal edge one key off;
    the newest key lost in self decode; and in every call the query
    heads on the wrong KV heads (:func:`wrong_kv_heads`).  Under the
    near-uniform attention of random weights, the last frame or the 28
    frames of the last, ragged 64-key block of 1,500 weigh less than the
    limit (recorded under ``unplanted_controls_limit_used``), so the cross
    decode is also held with the last frame's key planted on each query
    (score AUDIO_PLANT_SCORE), where losing that frame (``lengths`` less
    one) or that block must fail.  Returns {call: record}, each with the
    call's arguments under ``args`` for :func:`audio_timing`."""
    import torch

    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import mha_ref

    flash_k, decode_k = attn_counters()
    tol = ATTN_TOL["bfloat16"]
    out = {}

    def check(what, q, k, kfn, pfn, controls):
        H, K = q.shape[-2], k.shape[2]
        controls["query heads on the wrong KV heads"] = \
            lambda: wrong_kv_heads(pfn, q, k)
        kout, pout = kfn(q, k), pfn(q, k)
        err, used, mean_p, max_p = attn_compare(kout, pout, tol, what)
        ctl = attn_controls(pout, controls, tol, what)
        return {"call": what, "q": list(q.shape), "kv": list(k.shape),
                "group": H // K, "max_abs_err": err, "limit_used": used,
                "mean_abs_plain": mean_p, "max_abs_plain": max_p,
                "controls_limit_used": ctl}

    for name in AUDIO_CALLS:
        need(name in shapes, f"audio: no {name} call was recorded")
        if name.endswith("decode"):
            q, k, v, lengths, kw = shapes[name]
            need(not kw.get("window"), f"audio {name}: window {kw}")

            def kfn(q, k, v=v, lengths=lengths):
                return decode_k(q, k, v, lengths)

            def pfn(q, k, v=v, lengths=lengths):
                return decode_ref(q, k, v, lengths)

            controls = ({"newest key lost": lambda q=q, k=k, v=v, s=(
                lengths - 1).clamp(min=1): decode_ref(q, k, v, s)}
                        if name == "self decode" else {})
        else:
            q, k, v, kw = shapes[name]
            # the output is checked; the encoder's and the cross prefill's
            # log-sum-exp (FlashAttentionFn) only in training (11c)
            kw = {a: b for a, b in kw.items() if a != "return_lse"}
            causal, qoff = kw.get("causal", True), kw.get("q_offset", 0)
            need(causal == (name == "self prefill") and not kw.get("window"),
                 f"audio {name}: called with {kw}")

            def kfn(q, k, v=v, kw=kw):
                return flash_k(q, k, v, **kw)

            def pfn(q, k, v=v, kw=kw):
                return mha_ref(q, k, v, **kw)

            Skv = k.shape[1]
            if name == "encoder":
                controls = {"a causal encoder": lambda q=q, k=k, v=v: mha_ref(
                    q, k, v, causal=True)}
            elif name == "cross prefill":
                keep = Skv - (Skv % 128 or 128)
                need(keep > 0, f"audio: {Skv} frames leave no whole block")
                controls = {f"keys past {keep} dropped": lambda q=q, k=k,
                            v=v, n=keep: mha_ref(q, k[:, :n], v[:, :n],
                                                 causal=False)}
            else:
                controls = {"causal edge one key off": lambda q=q, k=k, v=v,
                            o=qoff: mha_ref(q, k, v, causal=True,
                                            q_offset=o - 1)}
        out[name] = check(f"{name}, layer 0", q, k, kfn, pfn, controls)
        out[name]["args"] = shapes[name]
        if name.endswith("decode"):
            out[name]["lengths"] = lengths.tolist()
        if name == "cross decode":
            ragged = lengths - torch.where(lengths % 64 > 0, lengths % 64, 64)
            need(bool((ragged > 0).all()), f"audio: lengths "
                 f"{lengths.tolist()} leave no whole 64-key block")
            last = (lengths.long() - 1).clamp(min=0)
            rows = torch.arange(q.shape[0], device=q.device)
            kp = k.clone()  # the key of each sequence's last frame, per head
            qf = q.float()
            kp[rows, last] = (qf * (AUDIO_PLANT_SCORE * q.shape[-1] ** 0.5
                                    / qf.square().sum(-1, keepdim=True))
                              ).to(k.dtype)
            lost = {"last frame lost (lengths - 1)": (lengths - 1).clamp(
                min=1), "frames of the ragged last block lost": ragged}
            out[name]["planted"] = check(
                f"{name}, layer 0, last frame planted", q, kp, kfn, pfn,
                {c: lambda q=q, kp=kp, v=v, n=n: decode_ref(q, kp, v, n)
                 for c, n in lost.items()})
            # the same two defects on the served inputs, recorded only
            plain = pfn(q, k).float()
            lim = attn_limit(plain, tol)
            out[name]["unplanted_controls_limit_used"] = {
                c: float(((decode_ref(q, k, v, n).float() - plain).abs()
                          / lim).max()) for c, n in lost.items()}
            del kp, plain, lim
    return out


def audio_timing(calls, rate, log=print):
    """Each audio call (:func:`audio_calls`) timed on the card: the kernel
    (device ms, CUDA-graph replay; kernel 4 with K/V out of L2,
    :func:`cold_ms`, as a decode step finds them), the plain version,
    and SDPA computing the same function (the flash backend, which takes
    MHA at d 64 without a mask: the prefill calls, and the decode calls
    over their one valid length), beside the bound: the larger of the
    bytes (q and the output, each key's K and V once, and the
    log-sum-exp where the call asks for it, as the encoder and the cross
    prefill do) over ``rate`` and 4·d operations a visible (query, key)
    pair a head over BF16_RATE.  Adds the numbers to each record and
    drops its ``args``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import mha_ref

    flash_k, decode_k = attn_counters()

    def sdpa(q, k, v, causal):  # (B, S, H, d) in and out
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal).transpose(1, 2)

    for name, rec in calls.items():
        args = rec.pop("args")
        if name.endswith("decode"):
            q, k, v, lengths, _ = args
            B, H, d = q.shape
            lens = lengths.long().clamp(0, k.shape[1])
            n = int(lens.max())
            need(bool((lens == n).all()), f"audio {name}: lengths "
                                          f"{lengths.tolist()} differ")
            pairs, keys = int(lens.sum()), int(lens.sum())
            lse_bytes = 0

            def kfn():
                return decode_k(q, k, v, lengths)

            def pfn():
                return decode_ref(q, k, v, lengths)

            def lfn():
                return sdpa(q[:, None], k[:, :n], v[:, :n], False)[:, 0]
            timer = cold_ms
        else:
            q, k, v, kw = args
            B, Sq, H, d = q.shape
            Skv = k.shape[1]
            causal = kw.get("causal", True)
            need(not causal or (Sq == Skv and not kw.get("q_offset")),
                 f"audio {name}: SDPA's causal mask needs Sq = Skv")
            pairs = B * (visible_pairs(Sq, Skv, 0, 0) if causal
                         else Sq * Skv)
            keys = B * Skv
            lse_bytes = 4 * B * H * Sq if kw.get("return_lse") else 0

            def kfn():
                return flash_k(q, k, v, **kw)

            def pfn():
                return mha_ref(q, k, v, **kw)

            def lfn():
                return sdpa(q, k, v, causal)
            timer = cuda_ms
        K = k.shape[2]
        moved = (2 * q.numel() * q.element_size()
                 + 2 * keys * K * d * k.element_size() + lse_bytes)
        ops = 4 * d * H * pairs
        plain = pfn()  # with the log-sum-exp where the call asks for it
        attn_compare(lfn(), plain[0] if lse_bytes else plain,
                     ATTN_TOL["bfloat16"], f"audio {name} library call")
        del plain
        t_bytes, t_ops = moved / rate, ops / BF16_RATE
        rec.update({"ms": timer(kfn), "plain_ms": timer(pfn),
                    "library_ms": timer(lfn), "library": "SDPA flash",
                    "bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations", "bytes": moved, "flop": ops})
        if timer is cold_ms:
            rec.update(timing="K/V out of L2", warm_ms=cuda_ms(kfn))
        log(f"  audio {name}: " + json.dumps(rec))
        del args
        torch.cuda.empty_cache()
    return calls


def audio_serve(cfg, card, device="cuda", log=print):
    """Phase 8c: the audio family (whisper) serving at ``cfg``'s width and
    depth, random weights and seeded random frames (AUDIO_BATCH clips of
    ``cfg.encoder_seq_len`` frames) from a seeded generator on the card,
    ``BatchedServer`` answering AUDIO_REQUESTS prompts of AUDIO_PROMPT
    tokens with AUDIO_NEW new tokens each at batch AUDIO_BATCH, the
    frames in ``extra_inputs``.  Records prefill seconds split into the
    encoder (:func:`timed_encoder`) and the decoder, decode seconds,
    tokens/s, peak memory, finite logits and the launches of kernels 3
    and 4 by route (on the card: every launch on SERVE_FLASH_ROUTE and
    SERVE_DECODE_ROUTE, E + 2L kernel-3 launches a prefill and 2L kernel-4
    launches a decode step); a second serve must give the same tokens;
    kernels 3 and 4 at the five layer-0 calls against their plain
    versions with wrong controls (:func:`audio_calls`); teacher forcing
    within PARITY_TOL; a profile of one prefill and four decode steps.
    Returns the record, with the calls' arguments for
    :func:`audio_timing`; the model is freed."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import (
        decode_step, init_model_params, init_serve_cache, prefill)

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_model_params(cfg, gen, device)
    frames = torch.randn((AUDIO_BATCH, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device=device)
    if on_card:
        torch.cuda.synchronize()

    n_params = sum(p.numel() for p in model.parameters())
    rec = {"arch": cfg.name, "encoder_layers": cfg.encoder_layers,
           "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim,
           "frames": list(frames.shape), "params": n_params,
           "param_count": cfg.param_count(), "init_s":
           time.perf_counter() - t0, "card": card}
    if on_card:
        rec["weights_GB"] = torch.cuda.memory_allocated() / 1e9
    need(n_params == schema_leaves(cfg),
         f"audio {cfg.name}: {n_params} parameters, its schema has "
         f"{schema_leaves(cfg)}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, AUDIO_PROMPT).astype(np.int32)
               for _ in range(AUDIO_REQUESTS)]
    flash, decode = attn_counters()

    def run():
        srv = BatchedServer(model, batch_size=AUDIO_BATCH,
                            max_len=AUDIO_PROMPT + AUDIO_NEW + 8)
        srv.extra_inputs["frames"] = frames
        done = srv.serve([Request(rid=i, tokens=p, max_new=AUDIO_NEW)
                          for i, p in enumerate(prompts)])
        return srv, [r.out for r in done]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    with timed_encoder() as enc_s, capture_audio_calls(cfg) as shapes:
        srv, outs = run()
    launches = {"flash_attention_cuda": flash.launches,
                "decode_attention_cuda": decode.launches}
    routes = {"flash_attention_cuda": dict(flash.launches_by_route),
              "decode_attention_cuda": dict(decode.launches_by_route)}
    st = srv.stats
    n_batches = -(-AUDIO_REQUESTS // AUDIO_BATCH)
    rec.update({
        "prefill_s": st["prefill_s"], "encoder_s": sum(enc_s),
        "decoder_prefill_s": st["prefill_s"] - sum(enc_s),
        "decode_s": st["decode_s"], "tokens": st["tokens"],
        "tokens_per_s": st["tokens"] / (st["prefill_s"] + st["decode_s"]),
        "decode_tokens_per_s": AUDIO_REQUESTS * (AUDIO_NEW - 1)
        / st["decode_s"], "finite": st["finite"],
        "launches": launches, "launches_by_route": routes})
    if on_card:
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    need(len(enc_s) == n_batches, f"audio: {len(enc_s)} encoder runs")
    need(len(outs) == AUDIO_REQUESTS, "audio: requests lost")
    need(all(len(o) == AUDIO_NEW for o in outs), "audio: token counts")
    need(all(0 <= t < cfg.vocab_size for o in outs for t in o),
         "audio: a padded vocab entry won")
    need(st["finite"], "audio: non-finite logits")
    if on_card:
        n_flash = (cfg.encoder_layers + 2 * cfg.num_layers) * n_batches
        n_decode = 2 * cfg.num_layers * (AUDIO_NEW - 1) * n_batches
        fr = routes["flash_attention_cuda"]
        dr = routes["decode_attention_cuda"]
        need(fr.get(SERVE_FLASH_ROUTE) == launches["flash_attention_cuda"]
             == n_flash, f"audio: the prefill's kernel-3 launches took the "
                         f"routes {fr}, not all {n_flash} "
                         f"{SERVE_FLASH_ROUTE}")
        need(dr.get(SERVE_DECODE_ROUTE) == launches["decode_attention_cuda"]
             == n_decode, f"audio: the decode launches took the routes "
                          f"{dr}, not all {n_decode} {SERVE_DECODE_ROUTE}")
    log(f"phase audio_serve: {json.dumps(rec)}")
    rec["calls"] = audio_calls(shapes, log)
    log("phase audio_attention_check: " + json.dumps(
        {k: {kk: vv for kk, vv in c.items() if kk != "args"}
         for k, c in rec["calls"].items()}))
    shapes.clear()
    srv2, outs2 = run()
    need(outs2 == outs, "audio: a second serve gave other tokens")
    rec["repeat"] = {"prefill_s": srv2.stats["prefill_s"],
                     "decode_s": srv2.stats["decode_s"],
                     "identical_tokens": True}
    log(f"  first tokens: {[o[:8] for o in outs]}")
    parity = parity_run(model, cfg, AUDIO_PROMPT, device,
                        extra={"frames": frames[:1]})
    rec["teacher_forcing"] = parity
    log(f"phase audio_teacher_forcing: {json.dumps(parity)}")
    # where the serving time goes: one prefill of the batch, four decode
    # steps, under the profiler
    B, S = AUDIO_BATCH, AUDIO_PROMPT
    toks = np.stack(prompts[:B])
    nxt = np.array([[o[0]] for o in outs[:B]], np.int32)
    cache = init_serve_cache(cfg, B, S + 12, device=device)
    rec["profile"] = {}

    def run_prefill():
        prefill(model, {"tokens": toks, "cache": cache, "frames": frames})

    def run_decode():
        for i in range(4):
            decode_step(model, {"tokens": nxt, "cache": cache,
                                "pos": np.full(B, S + i, np.int32)})

    for name, fn in (("prefill", run_prefill), ("decode x4", run_decode)):
        rec["profile"][name] = profile_window(name, fn, log,
                                              phase="audio_serve_profile")
    del model, srv, srv2, cache, frames
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def split_sweep(decode_k, args, log=print, counts=(1, 2, 4, 8, 16)):
    """Device ms of the decode kernel at one shape for several split
    counts with K/V out of L2 (:func:`cold_ms`; back to back under
    ``warm``), and for the schedule's own (``num_splits``, the wrapper's
    choice) under the key ``schedule``."""
    import torch

    from repro_torch.kernels.decode_attention import kernel

    q, k, v, lengths, window = args
    S, K = k.shape[1], k.shape[2]
    chosen = kernel.num_splits
    out, warm = {}, {}

    def call():
        return decode_k(q, k, v, lengths, window=window)

    try:
        for n in counts:
            kernel.num_splits = lambda *a, n=n: n
            out[n], warm[n] = cold_ms(call), cuda_ms(call)
    finally:
        kernel.num_splits = chosen
    out["warm"] = warm
    out["schedule"] = {
        "splits": chosen(q.shape[0] * K, min(S, window) if window else S,
                         torch.cuda.get_device_properties(
                             q.device).multi_processor_count),
        "ms": cold_ms(call), "warm_ms": cuda_ms(call)}
    log(f"  decode split sweep (ms by split count): {json.dumps(out)}")
    return out


def visible_pairs(Sq, Skv, q_offset, window):
    """(query, key) pairs the causal window mask lets through, per head
    and sequence."""
    import numpy as np

    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_report(shapes, launches, routes, card, rate, device="cuda",
                     log=print):
    """Each attention kernel timed at the serving run's shapes (layer 0,
    as ``capture_layer0`` recorded them)
    and at the repo's named 32k shapes: device ms (CUDA-graph replay),
    eager ms, plain ms, one PyTorch library call (SDPA, memory-efficient
    backend) as a yardstick, and the bound.  The decode kernel's device,
    plain and library ms are taken with K/V out of L2 (:func:`cold_ms`),
    as on the main path, and back to back under ``*warm_ms``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import DECODE_32K, PREFILL_32K, get_config
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import mha_ref

    flash_k, decode_k = attn_counters()
    calls = {"flash_attention_cuda": [], "decode_attention_cuda": []}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def library(fn, plain_out, what, strict=True, timer=cuda_ms):
        """Time the yardstick, or say why it could not run (it is never on
        the port's path).  A yardstick that disagrees with the plain
        version fails the smoke, or with ``strict=False`` (the second
        yardstick) is reported and not timed."""
        try:
            out = fn()
        except RuntimeError as e:  # a backend that refuses these inputs
            log(f"  {what}: library call unavailable: {str(e)[:300]}")
            return None, str(e)[:200]
        try:
            attn_compare(out, plain_out, ATTN_TOL["bfloat16"],
                         what + " library call")
        except SmokeFailure as e:
            if strict:
                raise
            log(f"  {what}: library call disagrees, not timed: {e}")
            return None, f"disagrees with plain: {e}"[:200]
        del out
        return timer(fn), None

    def finish(kernel, name, kfn, pfn, lfn, moved, ops, controls,
               cudnn_fn=None, cold=False):
        kout, pout = kfn(), pfn()
        err, used, mean_p, max_p = attn_compare(kout, pout,
                                                ATTN_TOL["bfloat16"], name)
        ctl = attn_controls(pout, controls, ATTN_TOL["bfloat16"], name)
        timer = cold_ms if cold else cuda_ms
        lib_ms, lib_note = library(lfn, pout, name, timer=timer)
        if cudnn_fn is not None:
            cudnn_ms, cudnn_note = library(cudnn_fn, pout, name + " (cuDNN)",
                                           strict=False)
        t_bytes, t_ops = moved / rate, ops / BF16_RATE
        rec = {"call": name, "ms": timer(kfn),
               "eager_ms": cuda_ms(kfn, graph=False),
               "plain_ms": timer(pfn), "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "flop": ops, "max_abs_err": err,
               "limit_used": used, "mean_abs_plain": mean_p,
               "max_abs_plain": max_p, "controls_limit_used": ctl}
        if lib_note:
            rec["library_note"] = lib_note
        if cold:
            rec.update(timing="K/V out of L2", warm_ms=cuda_ms(kfn),
                       plain_warm_ms=cuda_ms(pfn),
                       library_warm_ms=None if lib_ms is None
                       else cuda_ms(lfn))
        if cudnn_fn is not None:
            rec["cudnn_ms"] = cudnn_ms
            if cudnn_note:
                rec["cudnn_note"] = cudnn_note
        calls[kernel].append(rec)
        log(f"  {kernel} {name}: " + json.dumps(rec))
        del kout, pout
        torch.cuda.empty_cache()

    def flash_call(name, q, k, v, window, q_offset):
        B, Sq, H, d = q.shape
        Skv, K = k.shape[1], k.shape[2]
        G = H // K
        kw = dict(causal=True, window=window, q_offset=q_offset)
        kx = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vx = v.repeat_interleave(G, dim=2).transpose(1, 2)
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window

        def sdpa(backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), kx, vx, attn_mask=mask).transpose(1, 2)

        def lfn():
            return sdpa(SDPBackend.EFFICIENT_ATTENTION)

        def cudnn_fn():
            return sdpa(SDPBackend.CUDNN_ATTENTION)

        pairs = B * visible_pairs(Sq, Skv, q_offset, window)
        need(window > 32, f"{name}: the controls need a window, got {window}")
        controls = {
            "window edge one key off": lambda: mha_ref(
                q, k, v, causal=True, window=window - 1, q_offset=q_offset),
            "window's first 32 keys dropped": lambda: mha_ref(
                q, k, v, causal=True, window=window - 32, q_offset=q_offset),
            "causal edge one key off": lambda: mha_ref(
                q, k, v, causal=True, window=window, q_offset=q_offset - 1),
        }
        finish("flash_attention_cuda", name,
               lambda: flash_k(q, k, v, **kw), lambda: mha_ref(q, k, v, **kw),
               lfn, nbytes(q, q) + 2 * B * Skv * K * d * k.element_size(),
               4 * d * H * pairs, controls, cudnn_fn)

    def decode_call(name, q, k, v, lengths, window):
        B, H, d = q.shape
        S, K = k.shape[1], k.shape[2]
        G = H // K
        kx = k.transpose(1, 2).contiguous()
        vx = v.transpose(1, 2).contiguous()
        pos = torch.arange(S, device=q.device)[None]
        lens = lengths[:, None].long()
        mask = pos < lens
        if window:
            mask &= pos > lens - 1 - window
        mask = mask[:, None, None, :].expand(B, K, G, S)

        def lfn():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(
                    q.reshape(B, K, G, d), kx, vx,
                    attn_mask=mask).reshape(B, H, d)

        span = lengths.long().clamp(0, S)
        keys = int((span.clamp(max=window) if window else span).sum())
        need(window > 32, f"{name}: the controls need a window, got {window}")
        shorter = (lengths - 1).clamp(min=1)
        controls = {
            "window edge one key off": lambda: decode_ref(
                q, k, v, lengths, window=window - 1),
            "window's first 32 keys dropped": lambda: decode_ref(
                q, k, v, lengths, window=window - 32),
            "newest key lost": lambda: decode_ref(
                q, k, v, shorter, window=window - 1),
        }
        finish("decode_attention_cuda", name,
               lambda: decode_k(q, k, v, lengths, window=window),
               lambda: decode_ref(q, k, v, lengths, window=window), lfn,
               2 * keys * K * d * k.element_size() + nbytes(q, q, lengths),
               4 * d * H * keys, controls, cold=True)

    t0 = time.perf_counter()
    flash_call("serve prefill, layer 0", *shapes["flash"])
    decode_call("serve decode step 1, layer 0", *shapes["decode"])
    calls["decode_attention_cuda"][-1]["split_sweep_ms"] = split_sweep(
        decode_k, shapes["decode"], log)
    shapes.clear()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=device).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # prefill_32k's sequence (configs/base.py:34), one prompt
    S = PREFILL_32K.seq_len

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    flash_call(f"prefill_32k sequence (B=1, S={S})", randn(1, S, H, d),
               randn(1, S, K, d), randn(1, S, K, d), cfg.sliding_window, 0)
    torch.cuda.empty_cache()
    # decode_32k's cache (configs/base.py:35), one layer
    Bd, S = DECODE_32K.global_batch, DECODE_32K.seq_len
    lengths = torch.randint(1, S + 1, (Bd,), generator=gen, device=device,
                            dtype=torch.int32)
    decode_call(f"decode_32k cache (B={Bd}, S={S})", randn(Bd, H, d),
                randn(Bd, S, K, d), randn(Bd, S, K, d), lengths,
                cfg.sliding_window)
    torch.cuda.empty_cache()
    log(f"phase attention_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")

    meta = {
        "flash_attention_cuda": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:86"),
        "decode_attention_cuda": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:83"),
    }
    out = []
    for kernel, recs in calls.items():
        hot = recs[0]  # the serving run's shape
        out.append({
            "name": kernel, "route": "cuda", "source": meta[kernel][0],
            "replaces": meta[kernel][1], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "limit_used": max(r["limit_used"] for r in recs),
            "ms": hot["ms"], "eager_ms": hot["eager_ms"],
            "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
            "bound_by": hot["bound_by"], "library_ms": hot["library_ms"],
            "hot_call": hot["call"], "calls": recs, "card": card,
        })
        out[-1]["launches_by_route"] = routes[kernel]
        out[-1].update({key: hot[key] for key in ("timing", "warm_ms")
                        if key in hot})
        out[-1]["serve_route"] = (SERVE_FLASH_ROUTE
                                  if kernel == "flash_attention_cuda"
                                  else SERVE_DECODE_ROUTE)
    return out


# ---------------------------------------------------------------------------
# phase 11: LM training (starcoder2-7b at full width), the backward kernel
# ---------------------------------------------------------------------------

# starcoder2-7b at full width, TRAIN_4K's sequence (configs/base.py), cut in
# depth, batch and steps (each cut on the ``train path cuts`` line)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS = "starcoder2-7b", 4, 4, 4
TRAIN_PARAMS = 1_321_288_704  # 4 layers + embed + head + ln_f at full width
TRAIN_FLASH_ROUTE, TRAIN_BWD_ROUTE = "bf16_wgmma", "bf16_wgmma"
# (B, Sq, Skv, H, K, d, causal, window, dtype) of the backward against its
# plain version: the training layer's shape at batch 1 (window = S: the
# mask is causal only), a windowed case where the controls run, d 32 and
# 64 with S not a multiple of a block, a float32 case: the three routes
# (bf16 at d 64 and 128 wgmma, at d 32 mma.sync; float32), each held to
# its own; then without the mask, on each route: whisper's encoder (Sq =
# Skv = 1,500: a ragged last key block of 92 and query step of 28) and
# cross-attention (448 and 9 text tokens over 1,500 frames), MHA at d 64
BWD_CASES = [
    (1, 4096, 4096, 36, 4, 128, True, 4096, "bfloat16"),
    (1, 1000, 1000, 36, 4, 128, True, 256, "bfloat16"),
    (2, 333, 333, 8, 2, 64, True, 100, "bfloat16"),
    (2, 201, 201, 8, 4, 32, True, 0, "bfloat16"),
    (1, 257, 257, 9, 1, 128, True, 64, "float32"),
    (4, 1500, 1500, 16, 16, 64, False, 0, "bfloat16"),
    (4, 448, 1500, 16, 16, 64, False, 0, "bfloat16"),
    (4, 9, 1500, 16, 16, 64, False, 0, "bfloat16"),
    (2, 77, 200, 4, 4, 32, False, 0, "bfloat16"),
    (2, 150, 61, 4, 4, 64, False, 0, "float32"),
]
BWD_CONTROL_CASE = 1  # the windowed case: its window bites


def bwd_route(dtype, d):
    """The flash backward's route by (dtype name, head dim), as
    ``bwd_route`` in flash_attention_bwd.cu picks it."""
    if dtype == "float32":
        return "f32"
    return "bf16_wgmma" if d in (64, 128) else "bf16_mma_sync"


def grad_limit(ref, tol):
    """Elementwise limit on |kernel - plain| for an attention gradient (last
    dim the head dim): ``tol * (|ref| + 2 * max(row mean, tensor mean)
    |ref|)``, a row being one query's dq or one key's dk or dv of one
    head.  Unlike :func:`attn_limit`'s forward rows, which average V and
    stay of order 1, a gradient row sums the terms of every query or key
    it meets (thousands at the training shape, of the row's own size), so
    its absolute part scales with the row's mean uncapped: the kernel's
    bf16 rounding of P and dS leaves errors of that size on entries whose
    terms cancel.  The row mean is floored at the tensor's mean, since a
    row can be exactly 0 (dq of a causal head's first query: one visible
    key makes dS vanish).  The wrong controls exceed it many times."""
    import torch

    a = ref.abs()
    row = torch.maximum(a.mean(dim=-1, keepdim=True), a.mean())
    return tol * (a + 2.0 * row)


def grad_compare(got, want, tol, what):
    """Hold (dq, dk, dv) against the plain backward within
    :func:`grad_limit`.  Returns (max abs error, largest share of the
    limit used)."""
    import torch

    err_max, used_max = 0.0, 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        need(a.shape == b.shape, f"{what} {name}: shape {tuple(a.shape)}")
        need(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite")
        err = (a.float() - b.float()).abs()
        used = float((err / grad_limit(b.float(), tol)).max())
        need(used <= 1.0, f"{what} {name}: max abs error {float(err.max())}"
                          f" is {used:.3g}x the limit of grad_limit")
        err_max, used_max = max(err_max, float(err.max())), max(used_max,
                                                                used)
    return err_max, used_max


def same_tensors(a, b) -> bool:
    """Bit for bit (NaN included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def checkpoint_round_trip(model, opt_state, what, log=print):
    """One ``AsyncCheckpointer`` snapshot of the training state (the
    reference's tree: masters and moments) into a temporary directory,
    restored and compared bit for bit with the live state, then deleted.
    Logs ``phase <what>_checkpoint`` with its seconds and bytes."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.models import opt_state_to_numpy, params_to_numpy
    from repro_torch.train import checkpoint as ckpt

    root = tempfile.mkdtemp(prefix=f"{what}_ckpt_")
    try:
        saver = ckpt.AsyncCheckpointer(root, keep=1)
        t0 = time.perf_counter()
        state = {"params": params_to_numpy(model),
                 "opt": opt_state_to_numpy(model, opt_state)}
        saver.save(opt_state["step"], state)
        t_snap = time.perf_counter() - t0
        saver.wait()
        t_write = time.perf_counter() - t0 - t_snap
        n_bytes = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        restored, step = ckpt.restore(root, state)
        t_read = time.perf_counter() - t0
        # ``state`` is the live state's host copy (nothing has run since)
        names = [n for n, _ in ckpt._flatten_with_paths(state)]
        same = all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            ckpt._flatten_with_paths(state),
            ckpt._flatten_with_paths(restored)))
        del state, restored
        crec = {"seconds_snapshot": t_snap, "seconds_write": t_write,
                "seconds_restore": t_read, "bytes": n_bytes,
                "leaves": len(names), "step": step, "bitwise": same}
        log(f"phase {what}_checkpoint: {json.dumps(crec)}")
        need(same and step == opt_state["step"],
             f"{what}: the restored checkpoint differs from the live state")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return crec


def train_path(card, device="cuda", log=print):
    """The LM training path: starcoder2-7b at full width cut to
    TRAIN_LAYERS layers, ``train_loop`` for TRAIN_STEPS steps of
    TRAIN_BATCH sequences of TRAIN_4K's 4,096 tokens (bf16 compute,
    float32 masters and moments, ``remat="full"``), weights from seed 0.
    Every loss and gradient norm finite, no step skipped; kernel 3's
    launches (by route) and the backward's counted on this run.  Then one
    more step under ``torch.profiler`` (:func:`profile_window`), one
    ``AsyncCheckpointer`` snapshot of the trained state into a temporary
    directory, restored and compared bit for bit, and deleted; then a NaN
    control: NaN masters must give ``skipped = 1`` with parameters and
    moments bitwise unchanged."""
    import numpy as np
    import torch

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import flat_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step

    full = get_config(TRAIN_ARCH)
    cfg = full.with_overrides(num_layers=TRAIN_LAYERS)
    S = TRAIN_4K.seq_len
    need(cfg.remat == "full" and cfg.dtype == "bfloat16"
         and cfg.param_dtype == "float32",
         f"train: {cfg.name} is not bf16 compute over float32 masters with "
         f"full remat")
    log("train path cuts: " + json.dumps({
        "layers": [full.num_layers, TRAIN_LAYERS],
        "global_batch": [TRAIN_4K.global_batch, TRAIN_BATCH],
        "steps": TRAIN_STEPS, "seq_len": S,
        "width": "full (d_model 4608, 36 heads over 4, d_ff 18432, vocab "
                 "49152)"}))
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    t0 = time.perf_counter()
    out = train_loop(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                     seq_len=S, device=device, oc=oc, log_every=1, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_routes = dict(flash_attention_cuda.launches_by_route)
    bwd_routes = dict(flash_attention_bwd_cuda.launches_by_route)
    launches = {"flash_attention_cuda": flash_attention_cuda.launches,
                "flash_attention_bwd_cuda": flash_attention_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    model, opt_state = out["params"], out["opt_state"]
    n_params = sum(p.numel() for p in flat_leaves(model)[0])
    steps, prev = [], 0.0
    for h in out["history"]:
        secs = h["seconds"] - prev
        prev = h["seconds"]
        steps.append({"step": h["step"], "loss": h["loss"],
                      "grad_norm": h["grad_norm"], "lr": h["lr"],
                      "skipped": h["skipped"], "seconds": secs,
                      "tokens_per_s": TRAIN_BATCH * S / secs})
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "seconds": wall, "steps": steps, "peak_GB": peak,
           "launches": launches,
           "flash_launches_by_route": flash_routes,
           "bwd_launches_by_route": bwd_routes, "card": card}
    log(f"phase train: {json.dumps(rec)}")
    need(n_params == TRAIN_PARAMS, f"train: {n_params} parameters, not "
                                   f"{TRAIN_PARAMS}")
    need(len(steps) == TRAIN_STEPS, "train: steps lost")
    need(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
             for h in steps), "train: a non-finite loss or gradient norm")
    need(not any(h["skipped"] for h in steps), "train: a step was skipped")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the training path")
    n_fwd = 2 * cfg.num_layers * TRAIN_STEPS  # full remat: twice a layer
    need(flash_routes[TRAIN_FLASH_ROUTE] == launches["flash_attention_cuda"]
         == n_fwd, f"train: the flash launches took the routes "
                   f"{flash_routes}, not {n_fwd} {TRAIN_FLASH_ROUTE}")
    n_bwd = cfg.num_layers * TRAIN_STEPS
    need(bwd_routes[TRAIN_BWD_ROUTE] == launches["flash_attention_bwd_cuda"]
         == n_bwd, f"train: the backward launches took the routes "
                   f"{bwd_routes}, not {n_bwd} {TRAIN_BWD_ROUTE}")

    # where a step's time goes: one more step under the profiler (the
    # snapshot below is of the state after it)
    from repro_torch.train.data import SyntheticLMDataset

    data = SyntheticLMDataset(cfg.vocab_size, S, TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch_at(TRAIN_STEPS).items()}
    step_fn = make_train_step(cfg, oc)
    prof = profile_window("step", lambda: step_fn(model, opt_state, batch),
                          log, phase="train_profile")
    rec["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms",
                                           "idle_share")}

    checkpoint_round_trip(model, opt_state, "train", log)

    # the NaN guard on the same model: NaN masters, one step
    params = flat_leaves(model)[0]
    with torch.no_grad():
        for p in params:
            p.fill_(float("nan"))
    before = [t.clone() for t in params + opt_state["mu"] + opt_state["nu"]]
    t0 = time.perf_counter()
    _, _, m = step_fn(model, opt_state, batch)
    torch.cuda.synchronize()
    after = params + opt_state["mu"] + opt_state["nu"]
    unchanged = all(same_tensors(a, b) for a, b in zip(before, after))
    nrec = {"seconds": time.perf_counter() - t0,
            "skipped": float(m["skipped"]),
            "grad_norm": float(m["grad_norm"]), "unchanged": unchanged}
    log(f"phase train_nan_control: {json.dumps(nrec)}")
    need(nrec["skipped"] == 1.0 and unchanged,
         "train: NaN masters were not skipped with the state unchanged")
    del before, after, params, model, opt_state, out
    torch.cuda.empty_cache()
    return {"train": rec, "launches": launches,
            "routes": {"flash_attention_cuda": flash_routes,
                       "flash_attention_bwd_cuda": bwd_routes}}


def bwd_inputs(gen, B, S, H, K, d, dt, device, Skv=None):
    """q, k, v, dO of the backward's checks, from ``gen``: Skv keys (S
    when None)."""
    import torch

    dt = getattr(torch, dt)
    q, do = (torch.randn(B, S, H, d, generator=gen, device=device).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Skv or S, K, d, generator=gen,
                        device=device).to(dt) for _ in range(2))
    return q, k, v, do


def bwd_sweep(gen, device="cuda", log=print):
    """The flash backward against its plain version over BWD_CASES (the
    checks :func:`train_kernel_report` lists).  On the CPU the wrappers
    run their plain versions and launch nothing, so the route check is
    the card's alone; the other checks, the wrong controls included,
    hold there too."""
    import torch

    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    sweep = []
    for i, case in enumerate(BWD_CASES):
        B, Sq, Skv, H, K, d, causal, w, dt = case
        q, k, v, do = bwd_inputs(gen, B, Sq, H, K, d, dt, device, Skv)
        kw = dict(causal=causal, window=w)
        o0 = flash_attention_cuda(q, k, v, **kw)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        need(same_tensors(o0, o), f"flash {case}: the output with lse "
                                  f"differs from the output without")
        f = [t.float() for t in (q, k, v)]
        _, lse_p = mha_ref(*f, return_lse=True, **kw)
        lse_err = float((lse - lse_p).abs().max())
        need(lse_err <= 1e-5 * max(1.0, float(lse_p.abs().max())),
             f"flash {case}: lse off by {lse_err}")
        before = dict(flash_attention_bwd_cuda.launches_by_route)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        need(all(same_tensors(a, b) for a, b in zip(got, again)),
             f"flash backward {case}: two launches differ")
        routes = {r: n - before[r] for r, n in
                  flash_attention_bwd_cuda.launches_by_route.items() if
                  n - before[r]}
        need(routes == {bwd_route(dt, d): 2} or device != "cuda",
             f"flash backward {case}: launched on {routes}, not "
             f"{bwd_route(dt, d)}")
        f += [o.float(), lse, do.float()]
        want = mha_bwd_ref(*f, **kw)
        err, used = grad_compare(got, want, ATTN_TOL[dt],
                                 f"flash backward {case}")
        rec = {"case": list(case), "route": bwd_route(dt, d),
               "max_abs_err": err, "limit_used": used,
               "lse_err": lse_err, "repeat_bitwise": True}
        if i == BWD_CONTROL_CASE:
            rec["controls_limit_used"] = bwd_controls(got, {
                "no window mask": lambda: mha_bwd_ref(*f, causal=True,
                                                      window=0),
                "no D term": lambda: mha_bwd_ref(
                    f[0], f[1], f[2], torch.zeros_like(f[3]), f[4], f[5],
                    **kw)}, ATTN_TOL[dt], f"flash backward {case}")
        sweep.append(rec)
        log(f"  flash backward {case}: {json.dumps(rec)}")
        del q, k, v, do, o, lse, got, again, want, f
        if device == "cuda":
            torch.cuda.empty_cache()
    return sweep


#: the flash backward's three launches, by the kernel names the profiler
#: shows (the routes' kernels share these stems)
BWD_LAUNCHES = {"D": "bwd_row_dot", "dK_dV": "bwd_dkdv_", "dQ": "bwd_dq_"}


def profiled_device_ms(fn, reps=10):
    """Device milliseconds per call of ``fn`` by kernel (or copy) name:
    each one's device time under ``torch.profiler`` over ``reps`` calls,
    over ``reps``.  No host time is counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {e.key: e.self_device_time_total / 1e3 / reps
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    need(sum(out.values()) > 0, "the profiler saw no device time")
    return out


def bwd_launch_ms(fn, reps=10):
    """Device milliseconds per call of each of the flash backward's three
    launches (the D pre-pass, dK/dV, dQ) under ``torch.profiler`` over
    ``reps`` calls of ``fn`` (:func:`profiled_device_ms`), and their
    sum."""
    out = dict.fromkeys(BWD_LAUNCHES, 0.0)
    for key, ms in profiled_device_ms(fn, reps).items():
        for part, stem in BWD_LAUNCHES.items():
            if stem in key:
                out[part] += ms
    need(all(out.values()), f"flash backward: the profiler saw no time for "
                            f"some launch ({out})")
    out["sum"] = sum(out.values())
    return out


def train_kernel_report(train, card, rate, device="cuda", log=print):
    """The flash backward against its plain version on the card over
    BWD_CASES (bf16 within :func:`grad_limit` at the bf16 tol, float32 at
    the float32 tol; each case launched twice, bit for bit, on the route
    :func:`bwd_route` names), kernel 3's
    ``lse`` (its output with ``return_lse`` bit for bit the output without,
    its ``lse`` within 1e-5 of the plain log-sum-exp), and two wrong
    backwards that must fail the limit (no window mask, no D term).  Then
    both at the training layer's shape (B = TRAIN_BATCH), the backward
    held there too within :func:`grad_limit` against the plain float32
    backward on the same inputs: device ms (the three launches also apart,
    :func:`bwd_launch_ms`), eager ms, plain ms, the bound,
    and one PyTorch call as a yardstick, its forward for kernel 3 and its
    backward for the backward: SDPA on the flash backend with
    ``is_causal`` (GQA by ``enable_gqa``) where the window does not cut,
    which computes the same function (``library_ms``), and SDPA with the
    mask on the memory-efficient backend (``library_masked_ms``).
    Returns the backward's ``kernels`` row and kernel 3's training
    record."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    gen = torch.Generator(device=device).manual_seed(3)
    t0 = time.perf_counter()
    sweep = bwd_sweep(gen, device, log)

    # timing at the training layer's shape
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_BATCH, TRAIN_4K.seq_len
    H, K, d, w = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    q, k, v, do = bwd_inputs(gen, B, S, H, K, d, cfg.dtype, device)
    kw = dict(causal=True, window=w)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    pairs = B * H * visible_pairs(S, S, 0, w)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(moved, ops):
        t_bytes, t_ops = moved / rate, ops / BF16_RATE
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    G = H // K
    qx, kx, vx = (t.transpose(1, 2).detach().requires_grad_(True) for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)
    dox = do.transpose(1, 2)

    def sdpa(backend, *qkv, **how):
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(*qkv, **how)

    masked = (SDPBackend.EFFICIENT_ATTENTION, dict(attn_mask=mask))
    sd_out = sdpa(masked[0], qx, kx, vx, **masked[1])
    lib = {"masked": "efficient backend, the mask, K/V repeated"}
    if not w or w >= S:  # causal alone: the flash backend's own path
        kg, vg = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (k, v))
        try:
            causal = (SDPBackend.FLASH_ATTENTION,
                      dict(is_causal=True, enable_gqa=True))
            fl_in = (qx, kg, vg)
            fl_out = sdpa(causal[0], *fl_in, **causal[1])
            lib["causal"] = "flash backend, is_causal, enable_gqa"
        except RuntimeError as e:  # no GQA there: K/V repeated
            causal = (SDPBackend.FLASH_ATTENTION, dict(is_causal=True))
            fl_in = (qx, kx, vx)
            fl_out = sdpa(causal[0], *fl_in, **causal[1])
            lib["causal"] = (f"flash backend, is_causal, K/V repeated "
                             f"(enable_gqa: {str(e).splitlines()[0]})")
        lib_fwd = [(causal, fl_in), (masked, (qx, kx, vx))]
        lib_bwd = [(fl_out, fl_in), (sd_out, (qx, kx, vx))]
    else:
        lib_fwd, lib_bwd = [(masked, (qx, kx, vx))], [(sd_out, (qx, kx, vx))]

    def sdpa_fwd(how, qkv):
        return lambda: sdpa(how[0], *(t.detach() for t in qkv), **how[1])

    def sdpa_bwd(out, qkv):
        return lambda: torch.autograd.grad(out, qkv, dox, retain_graph=True)

    def library(fns, **kw):
        """library_ms (the first yardstick) and library_masked_ms."""
        ms = [cuda_ms(fn, graph=False, **kw) for fn in fns]
        return {"library_ms": ms[0], "library_masked_ms": ms[-1],
                "library": lib}

    fwd_ms, fwd_bound = cuda_ms(lambda: flash_attention_cuda(
        q, k, v, return_lse=True, **kw), reps=10), bound(
        nbytes(q, k, v, o, lse), 4 * d * pairs)
    fwd = {"call": f"train layer (B={B}, S={S}, window={w}), with lse",
           "ms": fwd_ms, "eager_ms": cuda_ms(lambda: flash_attention_cuda(
               q, k, v, return_lse=True, **kw), reps=10, graph=False),
           "plain_ms": cuda_ms(lambda: mha_ref(q, k, v, return_lse=True,
                                               **kw), reps=2, graph=False),
           **library([sdpa_fwd(*a) for a in lib_fwd], reps=5),
           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
           "flop": 4 * d * pairs, "card": card}
    log(f"  flash_attention_cuda train layer: {json.dumps(fwd)}")
    moved = nbytes(q, k, v, o, lse, do) + nbytes(q, k, v)
    b_ms, b_by = bound(moved, 10 * d * pairs)
    call = f"train layer (B={B}, S={S}, window={w})"
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = mha_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                       do.float(), **kw)
    t_err, t_used = grad_compare(got, want, ATTN_TOL[cfg.dtype],
                                 f"flash backward {call}")
    del got, want
    bwd = {"call": call, "max_abs_err": t_err, "limit_used": t_used,
           "ms": cuda_ms(lambda: flash_attention_bwd_cuda(
               q, k, v, o, lse, do, **kw), reps=10),
           "launch_ms": bwd_launch_ms(lambda: flash_attention_bwd_cuda(
               q, k, v, o, lse, do, **kw)),
           "eager_ms": cuda_ms(lambda: flash_attention_bwd_cuda(
               q, k, v, o, lse, do, **kw), reps=10, graph=False),
           "plain_ms": cuda_ms(lambda: mha_bwd_ref(q, k, v, o, lse, do,
                                                   **kw),
                               reps=2, warm=1, graph=False),
           **library([sdpa_bwd(*a) for a in lib_bwd], reps=5, warm=1),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
           "flop": 10 * d * pairs, "pairs": pairs}
    log(f"  flash_attention_bwd_cuda train layer: {json.dumps(bwd)}")
    del q, k, v, do, o, lse, qx, kx, vx, sd_out, lib_fwd, lib_bwd
    torch.cuda.empty_cache()
    log(f"phase train_kernel_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")
    row = {
        "name": "flash_attention_bwd_cuda", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:41 (no TPU kernel: "
                    "jax.value_and_grad through chunked_attention)",
        "launches": train["launches"]["flash_attention_bwd_cuda"],
        "launches_by_route": train["routes"]["flash_attention_bwd_cuda"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep + [bwd]),
        "limit_used": max(r["limit_used"] for r in sweep + [bwd]),
        "ms": bwd["ms"], "launch_ms": bwd["launch_ms"],
        "eager_ms": bwd["eager_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "library_masked_ms": bwd["library_masked_ms"],
        "hot_call": bwd["call"], "calls": sweep + [bwd], "card": card,
        "train_route": TRAIN_BWD_ROUTE,
    }
    return row, {"train_launches": train["launches"]["flash_attention_cuda"],
                 "train_launches_by_route":
                     train["routes"]["flash_attention_cuda"],
                 "train_route": TRAIN_FLASH_ROUTE, "train_call": fwd,
                 "lse_max_err": max(r["lse_err"] for r in sweep)}



# ---------------------------------------------------------------------------
# phase 11b: MoE training (dbrx-132b, llama4-maverick at full width)
# ---------------------------------------------------------------------------

# each run at full width (d_model, heads, head dim, d_ff kept), TRAIN_4K's
# 4,096-token sequence, bf16 compute over float32 masters and bfloat16
# moments (the reference's setting for these models,
# src/repro/launch/dryrun.py:106); cut in depth, experts (8 of 16 and 8 of
# 128: one card's share under 2-way expert parallelism; top k and the
# capacity factor kept), batch and steps (each cut on the ``moe_train
# cuts`` line).  dbrx: one MoE layer, 4 x 4,096 tokens a step in two
# micro-batches (C = 5,120), the config's full remat; llama4: one group, a
# dense layer then a MoE layer with the shared expert, 2 x 4,096 tokens in
# two micro-batches (C = 640), the dots policy
MOE_TRAIN_CUTS = (
    {"arch": "dbrx-132b", "layers": 1, "experts": 8, "global_batch": 4,
     "accum_steps": 2, "remat": "full", "steps": 4},
    {"arch": "llama4-maverick-400b-a17b", "layers": 2, "experts": 8,
     "global_batch": 2, "accum_steps": 2, "remat": "dots", "steps": 3},
)
MOE_TRAIN_STATE = "bfloat16"
# the remat op count: forward and backward over one sequence this long
MOE_REMAT_S = 256
# the MoE layer's gradients: these parameters where the layer has them
MOE_GRAD_NAMES = ("router", "wi", "wo", "shared_wi", "shared_wo")


def moe_train_configs():
    """(config, run) for each run of MOE_TRAIN_CUTS: the published config
    cut in depth and experts, under the run's remat policy; full width."""
    import dataclasses

    from repro_torch.configs import get_config

    out = []
    for run in MOE_TRAIN_CUTS:
        full = get_config(run["arch"])
        cfg = full.with_overrides(
            num_layers=run["layers"], remat=run["remat"],
            moe=dataclasses.replace(full.moe, num_experts=run["experts"]))
        need(all(getattr(cfg, a) == getattr(full, a) for a in (
            "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
            "vocab_size")), f"moe train {cfg.name}: not at full width")
        out.append((cfg, run))
    return out


def moe_train_launches(cfg, run):
    """(kernel 3's, the backward's) launches a run implies: per layer, per
    micro-batch and per step, the backward once and kernel 3 once in the
    forward and, under ``full`` and ``dots``, once more in the backward's
    recompute (the flash Function's output is no matmul that ``dots``
    keeps, and its kernel is no aten op the policy could cache)."""
    n = cfg.num_layers * run["accum_steps"] * run["steps"]
    return (1 if cfg.remat == "none" else 2) * n, n


@contextlib.contextmanager
def counted_attention():
    """While a path runs, count the calls of the attention wrappers made
    through ``models.attention`` (on the card each launches its kernel
    once; on the CPU they run the plain versions and launch nothing):
    ``{"flash_attention_cuda": n, "flash_attention_bwd_cuda": n}``."""
    from repro_torch.models import attention

    n = dict.fromkeys(("flash_attention_cuda", "flash_attention_bwd_cuda"),
                      0)
    orig = {k: getattr(attention, k) for k in n}

    def counting(name):
        def call(*a, **kw):
            n[name] += 1
            return orig[name](*a, **kw)
        return call

    for k in n:
        setattr(attention, k, counting(k))
    try:
        yield n
    finally:
        for k, fn in orig.items():
            setattr(attention, k, fn)


@contextlib.contextmanager
def capture_train_layer0(pick):
    """While a training run goes, record (copies of) what the flash
    backward is given at the calls that ``pick(n, q, k, kw)`` names (``n``
    counts the calls from 1; None names none, and a later call of a name
    replaces the earlier).  The backward runs the layers last to first,
    so layer 0 of the first micro-batch is call ``n_layers``, and the
    last call of a kind is layer 0's of the last micro-batch.
    ``got[name]`` is (q, k, v, o, lse, dO, the call's mask keywords)."""
    from repro_torch.models import attention

    got, calls = {}, [0]
    bwd = attention.flash_attention_bwd_cuda

    def rec(q, k, v, o, lse, do, **kw):
        calls[0] += 1
        name = pick(calls[0], q, k, kw)
        if name is not None:
            got[name] = tuple(t.detach().clone() for t in (
                q, k, v, o, lse, do)) + (dict(kw),)
        return bwd(q, k, v, o, lse, do, **kw)

    attention.flash_attention_bwd_cuda = rec
    try:
        yield got
    finally:
        attention.flash_attention_bwd_cuda = bwd


def wrong_kv_heads_bwd(q, k, v, o, lse, do, **kw):
    """Wrong control: the plain backward with query head h reading KV head
    h % K in place of h // G (:func:`wrong_kv_heads`), so that dK and dV
    sum over the wrong query heads."""
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref

    B, S, H, d = q.shape
    K = k.shape[2]
    G = H // K

    def regroup(t, axis):  # head g * K + j -> j * G + g
        shape = t.shape[:axis] + (G, K) + t.shape[axis + 1:]
        return t.reshape(shape).transpose(axis, axis + 1).reshape(t.shape)

    def back(t):  # the inverse, on dq
        shape = t.shape[:2] + (K, G) + t.shape[3:]
        return t.reshape(shape).transpose(2, 3).reshape(t.shape)

    dq, dk, dv = mha_bwd_ref(regroup(q, 2), k, v, regroup(o, 2),
                             regroup(lse, 1), regroup(do, 2), **kw)
    return back(dq), dk, dv


def bwd_shares(got, wrong, tol):
    """The largest share of :func:`grad_limit` that each of the kernel's
    (dq, dk, dv) uses against a wrong backward's: [dq, dk, dv]."""
    return [float(((a.float() - c.float()).abs()
                   / grad_limit(c.float(), tol)).max())
            for a, c in zip(got, wrong)]


def bwd_controls(got, controls, tol, what):
    """Deliberately wrong backwards ({name: a thunk giving (dq, dk, dv)})
    must each exceed :func:`grad_limit` against the kernel's ``got``:
    proof that the check sees such defects at this shape.  Returns
    {control: the largest share of the limit}."""
    out = {}
    for name, fn in controls.items():
        out[name] = max(bwd_shares(got, fn(), tol))
        need(out[name] > 1.0, f"{what}: the control '{name}' stays within "
                              f"the limit ({out[name]:.3g}x)")
    return out


def train_attention_check(call, name, fwd_controls, bwd_wrong):
    """Kernel 3 with ``lse`` and the flash backward at one training call,
    as :func:`capture_train_layer0` recorded it (no window, no query
    offset).  Kernel 3 relaunched on q, k, v gives the training forward's
    o and lse bit for bit, its output is within :func:`attn_limit` of
    ``mha_ref``'s and its lse within 1e-5 of the plain log-sum-exp; the
    backward is within :func:`grad_limit` of ``mha_bwd_ref`` in float32
    on the same inputs, at the bf16 tolerance.  Wrong controls must exceed
    each limit: ``fwd_controls`` {name: fn(q, k, v) giving the output},
    ``bwd_wrong`` {name: fn(f) giving (dq, dk, dv)}, ``f`` the plain
    backward's float32 inputs (q, k, v, o, lse, dO).  Returns ({kernel:
    record}, the kernel's (dq, dk, dv), f)."""
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    q, k, v, o, lse, do, kw = call
    need(not kw.get("window") and not kw.get("q_offset"),
         f"{name}: recorded with {kw}")
    H, K = q.shape[2], k.shape[2]
    tol = ATTN_TOL["bfloat16"]
    kw = dict(causal=kw.get("causal", True), window=0)
    o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    need(same_tensors(o2, o) and same_tensors(lse2, lse),
         f"{name}: kernel 3 relaunched differs from the training forward")
    pout, plse = mha_ref(q, k, v, return_lse=True, **kw)
    err, used, mean_p, max_p = attn_compare(o2, pout, tol, name)
    lse_err = float((lse2 - plse).abs().max())
    need(lse_err <= 1e-5 * max(1.0, float(plse.abs().max())),
         f"{name}: lse off by {lse_err}")
    ctl = attn_controls(pout, {c: (lambda fn=fn: fn(q, k, v))
                               for c, fn in fwd_controls.items()}, tol, name)
    out = {"flash_attention_cuda": {
        "call": name + ", with lse", "q": list(q.shape), "kv": list(k.shape),
        "group": H // K, "max_abs_err": err, "limit_used": used,
        "lse_err": lse_err, "mean_abs_plain": mean_p, "max_abs_plain": max_p,
        "controls_limit_used": ctl, "training_bits": True}}
    del o2, lse2, pout, plse
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    f = [t.float() for t in (q, k, v, o)] + [lse, do.float()]
    err, used = grad_compare(got, mha_bwd_ref(*f, **kw), tol,
                             f"{name} backward")
    out["flash_attention_bwd_cuda"] = {
        "call": name, "q": list(q.shape), "kv": list(k.shape),
        "group": H // K, "max_abs_err": err, "limit_used": used,
        "controls_limit_used": bwd_controls(
            got, {c: (lambda fn=fn: fn(f)) for c, fn in bwd_wrong.items()},
            tol, f"{name} backward")}
    return out, got, f


def moe_train_attention_check(shapes, cfg):
    """:func:`train_attention_check` at one MoE model's layer 0 of the
    first micro-batch (query groups of G = H / K, causal, no window).
    Wrong controls: the causal edge one key off, and the query heads read
    by the wrong KV heads (for the backward, dK and dV summed over the
    wrong query heads).  Returns {kernel: record}."""
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    kw = dict(causal=True, window=0)
    return train_attention_check(shapes["causal"], f"{cfg.name} train "
                                 f"layer 0", {
        "causal edge one key off": lambda q, k, v: mha_ref(
            q, k, v, q_offset=-1, **kw),
        "query heads on the wrong KV heads": lambda q, k, v: wrong_kv_heads(
            lambda q, k: mha_ref(q, k, v, **kw), q, k)}, {
        "causal edge one key off": lambda f: mha_bwd_ref(
            *f, q_offset=-1, **kw),
        "dK/dV over the wrong query heads": lambda f: wrong_kv_heads_bwd(
            *f, **kw)})[0]


def moe_layer_grads(fn, p, x, cot, names):
    """(output, {"x" and each of ``names``: the gradient}) of
    ``sum(fn(x) * cot)``, the weights ``p[name]``."""
    import torch

    xs = x.detach().requires_grad_(True)
    out = fn(xs)
    grads = torch.autograd.grad((out.to(cot.dtype) * cot).sum(),
                                [xs] + [p[n] for n in names])
    return out.detach(), dict(zip(("x",) + names, grads))


def grads_limit_used(got, want, tol, what):
    """The largest share of :func:`grad_limit` (per row of each
    gradient's last dim) that any entry of each gradient in ``got`` uses
    against ``want``.  Returns {name: share}."""
    import torch

    out = {}
    for n, w in want.items():
        a = got[n]
        need(a.shape == w.shape, f"{what} d{n}: shape {tuple(a.shape)}")
        need(bool(torch.isfinite(a).all()), f"{what} d{n}: non-finite")
        out[n] = float(((a.float() - w.float()).abs()
                        / grad_limit(w.float(), tol)).max())
    return out


def moe_grad_check(model, cfg, gen, device="cuda", log=print):
    """The MoE layer's gradient at full width: ``moe_apply_local`` on the
    model's first MoE layer (its float32 masters), differentiated with
    respect to x, the router, the expert stacks and the shared expert's
    weights, the loss the sum of its output times a fixed random
    cotangent, against the same gradients of :func:`moe_token_loop`,
    within :func:`grad_limit` at the float32 tolerance: MOE_CHECK_T random
    tokens at the config's capacity, then MOE_DROP_DISTINCT tokens each
    repeated at MOE_DROP_CF, where entries must drop.  Both take x in
    float64, so that the experts compute in float64 (routing stays
    float32, as the layer's) and a difference is one of formulation, not
    of rounding: in bf16 the layer's rounded intermediates put its weight
    gradients about the bf16 tolerance from a float32 loop's, and in
    float32 the sums over d_model and d_ff reach the float32 limit where
    one token makes a whole row of a weight's gradient.  Two wrong
    controls must exceed the limit: the gates not renormalised, and
    dropped entries written by assignment (at the dropping capacity).
    The router's gradient is compared under top k > 1 only.  Returns the
    records."""
    import dataclasses

    import torch

    from repro_torch.models import moe

    p = model.stacked_layers("moe")[0].moe
    # top 1: the renormalised gate is 1, so the output's gradient with
    # respect to the router is 0 but for rounding (the router learns
    # through the aux loss alone); it is compared under top k > 1
    names = tuple(n for n in MOE_GRAD_NAMES if n in p and (
        n != "router" or cfg.moe.top_k > 1))
    tol = ATTN_TOL["float32"]
    x = torch.randn((MOE_CHECK_T, cfg.d_model), generator=gen,
                    device=device).double()
    reps = MOE_CHECK_T // MOE_DROP_DISTINCT
    drop_cfg = cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DROP_CF))
    out = {}
    for name, c, xs in (("nominal", cfg, x),
                        ("dropping", drop_cfg,
                         x[:MOE_DROP_DISTINCT].repeat_interleave(reps, 0))):
        what = f"moe train {cfg.name} {name}"
        cot = torch.randn(xs.shape, generator=gen, device=device).double()

        def layer(x):
            return moe.moe_apply_local(p, x[None], c)[0][0]

        loop = {}

        def token_loop(x):
            y, loop["dropped"] = moe_token_loop(p, x, c)
            return y

        with moe_dispatches() as calls:
            _, got = moe_layer_grads(layer, p, xs, cot, names)
        _, want = moe_layer_grads(token_loop, p, xs, cot, names)
        n_drop = int((calls[0][1] == 0).sum())
        need(n_drop == loop["dropped"], f"{what}: {n_drop} entries dropped, "
                                        f"the host's rule drops "
                                        f"{loop['dropped']}")
        used = grads_limit_used(got, want, tol, what)
        need(max(used.values()) <= 1.0, f"{what}: gradients use {used} of "
                                        f"grad_limit (tol {tol}) against "
                                        f"the token loop")
        if name == "dropping":
            need(n_drop > 0, f"{what}: nothing dropped")
            control = ("dropped_by_assignment", "_dispatch",
                       dispatch_by_assignment)
        else:
            control = ("no_renormalisation", "_route", route_no_renorm)
        err = {n: float((got[n] - want[n]).abs().max()) for n in want}
        del got
        with moe_patched(*control[1:]):
            _, bad = moe_layer_grads(layer, p, xs, cot, names)
        bad_used = max(grads_limit_used(bad, want, tol, what).values())
        need(bad_used > 1.0, f"{what}: the control '{control[0]}' stays "
                             f"within the limit ({bad_used:.3g}x)")
        out[name] = {
            "tokens": xs.shape[0], "capacity": moe._capacity(xs.shape[0], c),
            "dropped": n_drop, "limit_used": used, "max_abs_err": err,
            "mean_abs_plain": {n: float(w.float().abs().mean())
                               for n, w in want.items()},
            "controls_limit_used": {control[0]: bad_used}}
        del want, bad
    return out


def remat_op_counts(model, cfg, S, device="cuda"):
    """What a layer's remat policy recomputes, by op count: ``forward_train``
    over one sequence of S tokens and its backward, under the config's
    policy and under ``none``, counting the experts' ``bmm``s (the
    forward's two shapes, (E, C, d) x (E, d, 2f) and (E, C, f) x (E, f,
    d)), the ``mm``s (and ``addmm``s) and the calls of kernel 3's wrapper,
    each in the forward and in the backward.  What the backward runs
    beyond ``none``'s is what the policy recomputed: the reference's
    ``checkpoint_dots_with_no_batch_dims`` keeps the products without a
    batch dimension, so under ``dots`` the experts' ``bmm``s (their expert
    axis a batch dimension) and kernel 3 run again and no ``mm`` does;
    under ``full`` everything in the layers runs again.  Returns
    {"forward", "backward": {policy: counts}, "recomputed": counts}."""
    import collections

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import forward_train, moe
    from repro_torch.models.model import flat_leaves

    aten = torch.ops.aten
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    C = moe._capacity(S, cfg)
    expert = {((E, C, d), (E, d, 2 * f)), ((E, C, f), (E, f, d))}

    class Count(TorchDispatchMode):
        def __init__(self, n):
            super().__init__()
            self.n = n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is aten.bmm.default and (
                    tuple(args[0].shape), tuple(args[1].shape)) in expert:
                self.n["expert_bmm"] += 1
            elif func in (aten.mm.default, aten.addmm.default):
                self.n["mm"] += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                           device=device)
    batch = {"tokens": toks, "labels": toks}
    params = flat_leaves(model)[0]
    counts = {"forward": {}, "backward": {}}
    for r in dict.fromkeys(("none", cfg.remat)):
        model.cfg = cfg.with_overrides(remat=r)
        fwd, bwd = collections.Counter(), collections.Counter()
        try:
            with counted_attention() as attn:
                with Count(fwd):
                    loss, _ = forward_train(model, batch)
                fwd["flash"] = attn["flash_attention_cuda"]
                with Count(bwd):
                    grads = torch.autograd.grad(loss, params)
                bwd["flash"] = attn["flash_attention_cuda"] - fwd["flash"]
        finally:
            model.cfg = cfg
        del loss, grads
        counts["forward"][r], counts["backward"][r] = dict(fwd), dict(bwd)
    n_moe = sum(layer.kind == "moe" for layer in model.layers)
    keys = ("expert_bmm", "mm", "flash")
    b = counts["backward"]
    counts["recomputed"] = {k: b[cfg.remat].get(k, 0) - b["none"].get(k, 0)
                            for k in keys}
    rec = counts["recomputed"]
    what = f"moe train {cfg.name} remat {cfg.remat!r}"
    need(all(counts["forward"][r].get("expert_bmm") == 2 * n_moe
             for r in counts["forward"]),
         f"{what}: the forward ran {counts['forward']} expert bmms, not "
         f"{2 * n_moe}")
    need(not b["none"].get("expert_bmm"), f"{what}: an expert product of "
                                          f"the forward's shape ran in "
                                          f"the backward under none")
    if cfg.remat in ("dots", "full"):
        need(rec["expert_bmm"] == 2 * n_moe and rec["flash"]
             == cfg.num_layers, f"{what}: recomputed {rec}, not the "
                                f"{2 * n_moe} expert bmms and "
                                f"{cfg.num_layers} kernel 3 calls")
    if cfg.remat == "dots":
        need(rec["mm"] == 0, f"{what}: {rec['mm']} mms recomputed")
    if cfg.remat == "full":
        need(rec["mm"] > 0, f"{what}: no mm recomputed")
    return counts


def moe_train_one(cfg, run, card, device="cuda", log=print, seq_len=None):
    """One MoE model trained at full width, cut as ``run`` says:
    ``train_loop`` for ``run["steps"]`` steps of ``run["global_batch"]``
    sequences of ``seq_len`` (TRAIN_4K's 4,096 unless given) tokens in
    ``run["accum_steps"]`` micro-batches, bf16 compute over float32
    masters and MOE_TRAIN_STATE moments, weights from seed 0.  Every
    step's loss, ce and aux finite, aux > 0, no step skipped; each
    dispatch over one micro-batch's tokens, and the recompute's drops the
    forward's; kernel 3's and the backward's launches by route, as many as
    the policy implies (:func:`moe_train_launches`), each on its
    training route (TRAIN_FLASH_ROUTE, TRAIN_BWD_ROUTE).
    Then one more step under ``torch.profiler`` (with the run's peak
    memory), the
    attention kernels at layer 0's training shapes
    (:func:`moe_train_attention_check`), the MoE layer's gradient against
    the token loop (:func:`moe_grad_check`), and the policy's recompute by
    op count (:func:`remat_op_counts`).  The model is freed before it
    returns."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import TRAIN_4K
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda as bwd)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda as flash)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import moe
    from repro_torch.models.model import flat_leaves
    from repro_torch.train.data import SyntheticLMDataset
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step

    on_card = torch.device(device).type == "cuda"
    S = seq_len or TRAIN_4K.seq_len
    B, accum, steps = run["global_batch"], run["accum_steps"], run["steps"]
    need(cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
         and cfg.remat == run["remat"], f"moe train {cfg.name}: not bf16 "
                                        f"over float32 masters under "
                                        f"{run['remat']!r}")
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=steps,
                   state_dtype=MOE_TRAIN_STATE)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_attn_launches()
    t0 = time.perf_counter()
    def layer0(n, *_):  # of the first micro-batch
        return "causal" if n == cfg.num_layers else None

    with counted_attention() as calls, moe_dispatches() as dispatches, \
            capture_train_layer0(layer0) as shapes:
        out = train_loop(cfg, steps=steps, global_batch=B, seq_len=S,
                         device=device, oc=oc, accum_steps=accum,
                         log_every=1, seed=0)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_cuda": flash.launches,
                "flash_attention_bwd_cuda": bwd.launches}
    routes = {"flash_attention_cuda": dict(flash.launches_by_route),
              "flash_attention_bwd_cuda": dict(bwd.launches_by_route)}
    model, opt_state = out["params"], out["opt_state"]
    n_params = sum(p.numel() for p in flat_leaves(model)[0])
    T = B // accum * S
    n_moe = sum(layer.kind == "moe" for layer in model.layers)
    hist, prev = [], 0.0
    for h in out["history"]:
        hist.append({k: h[k] for k in ("step", "loss", "ce", "aux",
                                       "grad_norm", "lr", "skipped")})
        hist[-1]["seconds"] = h["seconds"] - prev
        hist[-1]["tokens_per_s"] = B * S / hist[-1]["seconds"]
        prev = h["seconds"]
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "kinds": [layer.kind for layer in model.layers],
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "d_ff": cfg.d_ff, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "capacity_factor":
           cfg.moe.capacity_factor, "shared_expert": cfg.moe.shared_expert,
           "params": n_params, "param_count": cfg.param_count(),
           "remat": cfg.remat, "state_dtype": MOE_TRAIN_STATE,
           "tokens_a_step": B * S, "accum_steps": accum,
           "capacity": moe._capacity(T, cfg), "seconds": wall,
           "steps": hist, "launches": launches, "launches_by_route": routes,
           "wrapper_calls": dict(calls),
           "drop_share_by_dispatch": [
               float((keep == 0).float().mean()) for _, keep in dispatches],
           "card": card}
    if on_card:
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase moe_train_{cfg.name}: {json.dumps(rec)}")
    what = f"moe train {cfg.name}"
    need(n_params == schema_params(cfg), f"{what}: {n_params} parameters, "
                                         f"not {schema_params(cfg)}")
    need(len(hist) == steps, f"{what}: steps lost")
    need(all(np.isfinite([h[k] for k in ("loss", "ce", "aux", "grad_norm")])
             .all() and h["aux"] > 0 for h in hist),
         f"{what}: a non-finite loss, ce, aux or gradient norm, or aux 0")
    need(not any(h["skipped"] for h in hist), f"{what}: a step was skipped")
    # each micro-batch's dispatches: the forward's, layer by layer, then
    # the recompute's, last layer first, dropping the same entries
    per = n_moe * (1 if cfg.remat == "none" else 2)
    need(len(dispatches) == per * accum * steps
         and all(n == T for n, _ in dispatches),
         f"{what}: {len(dispatches)} dispatches over "
         f"{sorted({n for n, _ in dispatches})} tokens, not "
         f"{per * accum * steps} over {T}")
    if cfg.remat != "none":
        for i in range(0, len(dispatches), per):
            fwd, again = dispatches[i:i + n_moe], dispatches[i + n_moe:
                                                             i + per][::-1]
            need(all(torch.equal(a[1], b[1]) for a, b in zip(fwd, again)),
                 f"{what}: the recompute dropped other entries")
    n_fwd, n_bwd = moe_train_launches(cfg, run)
    need(calls == {"flash_attention_cuda": n_fwd,
                   "flash_attention_bwd_cuda": n_bwd},
         f"{what}: attention calls {calls}, not {n_fwd} and {n_bwd}")
    if on_card:
        for k, n, route in zip(launches, (n_fwd, n_bwd),
                               (TRAIN_FLASH_ROUTE, TRAIN_BWD_ROUTE)):
            need(routes[k].get(route) == launches[k] == n,
                 f"{what}: {k} took the routes {routes[k]}, not {n} "
                 f"{route}")
    del dispatches

    # where a step's time goes: one more step under the profiler
    data = SyntheticLMDataset(cfg.vocab_size, S, B)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch_at(steps).items()}
    step_fn = make_train_step(cfg, oc, accum_steps=accum)
    prof = profile_window("step", lambda: step_fn(model, opt_state, batch),
                          log, phase=f"moe_train_profile_{cfg.name}")
    rec["profile"] = {k: prof.get(k) for k in ("wall_ms", "device_ms",
                                               "idle_share", "peak_GB")}
    del batch

    t1 = time.perf_counter()
    rec["attention_check"] = moe_train_attention_check(shapes, cfg)
    shapes.clear()
    log(f"phase moe_train_attention_check_{cfg.name}: "
        f"{json.dumps(rec['attention_check'])}")
    gen = torch.Generator(device=device).manual_seed(5)
    rec["grad_check"] = moe_grad_check(model, cfg, gen, device, log)
    log(f"phase moe_train_grad_check_{cfg.name}: "
        f"{json.dumps(rec['grad_check'])}")
    rec["remat_ops"] = remat_op_counts(model, cfg, MOE_REMAT_S, device)
    log(f"phase moe_train_remat_ops_{cfg.name}: "
        f"{json.dumps(rec['remat_ops'])}")
    rec["checks_seconds"] = time.perf_counter() - t1
    del model, opt_state, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


def moe_train_path(runs, card, device="cuda", log=print, seq_len=None):
    """Phase 11b: each (config, run) of ``runs`` through
    :func:`moe_train_one`, one model on the card at a time, after the
    ``moe_train cuts`` line.  Returns {arch: record}."""
    from repro_torch.configs import TRAIN_4K, get_config

    cuts = {}
    for cfg, run in runs:
        full = get_config(cfg.name)
        cuts[cfg.name] = {
            "layers": [full.num_layers, cfg.num_layers],
            "experts": [full.moe.num_experts, cfg.moe.num_experts],
            "top_k": cfg.moe.top_k,
            "capacity_factor": cfg.moe.capacity_factor,
            "global_batch": [TRAIN_4K.global_batch, run["global_batch"]],
            "accum_steps": run["accum_steps"], "steps": run["steps"],
            "seq_len": seq_len or TRAIN_4K.seq_len, "remat": cfg.remat,
            "state_dtype": MOE_TRAIN_STATE,
            "width": {a: getattr(cfg, a) for a in (
                "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                "vocab_size")}}
    log(f"moe_train cuts: {json.dumps(cuts)}")
    return {cfg.name: moe_train_one(cfg, run, card, device, log, seq_len)
            for cfg, run in runs}


# ---------------------------------------------------------------------------
# phase 11c: whisper-medium training at full width and depth
# ---------------------------------------------------------------------------

# whisper-medium (AUDIO_ARCH) trained through ``make_train_step``: 24
# encoder and 24 decoder layers at d_model 1,024, 16 heads of 64, weights
# from seed 0, bf16 compute over float32 masters and moments, the config's
# full remat; a step takes AUDIO_TRAIN_CLIPS clips of 1,500 frames (random
# from a seed) with transcripts of AUDIO_TRAIN_TEXT tokens (whisper's
# n_text_ctx) from ``SyntheticLMDataset``; AUDIO_TRAIN_STEPS steps, then
# one more under the profiler
AUDIO_TRAIN_CLIPS, AUDIO_TRAIN_TEXT, AUDIO_TRAIN_STEPS = 4, 448, 3
AUDIO_TRAIN_ROUTE = "bf16_wgmma"
#: phase 11c's depth cuts by name, [planned, run]; empty: nothing is cut
AUDIO_TRAIN_CUTS = {}
#: the no-mask attention calls of a training step, by kind: the encoder's
#: self-attention (Sq = Skv) and the decoder's cross-attention (Sq text
#: tokens over Skv frames)
AUDIO_TRAIN_KINDS = ("encoder", "cross")


def audio_train_launches(cfg):
    """(kernel 3's, the backward's) launches a step: per encoder layer one
    no-mask call, per decoder layer a causal and a cross call; under full
    remat kernel 3 runs again in each layer's recompute."""
    n = cfg.encoder_layers + 2 * cfg.num_layers
    return (1 if cfg.remat == "none" else 2) * n, n


def audio_train_kind(n, q, k, kw):
    """For :func:`capture_train_layer0`: the kind (AUDIO_TRAIN_KINDS) of a
    no-mask backward call, None for the decoder's causal self-attention.
    The backward runs the decoder's layers and then the encoder's, last to
    first, so the last call of a kind is layer 0's."""
    if kw.get("causal", True):
        return None
    return "encoder" if q.shape[1] == k.shape[1] else "cross"


def plant_last_frame(q, k, gen, score=AUDIO_PLANT_SCORE):
    """(q', k'): the last frame's key of each (batch, KV head) set to a
    unit vector u of that head times a, and a u added to each query of the
    heads that read it, a^2 / sqrt(d) = ``score``: every query then gives
    the last frame about ``score`` above the near-uniform rest of its
    row."""
    import torch

    B, _, H, d = q.shape
    K = k.shape[2]
    u = torch.randn(B, 1, K, d, generator=gen, device=q.device)
    u = u / u.norm(dim=-1, keepdim=True)
    a = (score * d ** 0.5) ** 0.5
    qp = (q.float() + a * u.repeat_interleave(H // K, dim=2)).to(q.dtype)
    kp = k.clone()
    kp[:, -1:] = (a * u).to(k.dtype)
    return qp, kp


def padded_keys_bwd(q, k, v, do, keep, **kw):
    """Wrong control: the plain forward and backward over the first
    ``keep`` keys only, dK and dV 0 on the keys past them."""
    import torch

    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    o, lse = mha_ref(q, k[:, :keep], v[:, :keep], return_lse=True, **kw)
    dq, dk, dv = mha_bwd_ref(q, k[:, :keep], v[:, :keep], o, lse, do, **kw)
    pad = torch.zeros_like(k[:, keep:], dtype=dk.dtype)
    return dq, torch.cat([dk, pad], 1), torch.cat([dv, pad], 1)


def audio_train_attention_check(shapes, gen, log=print):
    """:func:`train_attention_check` at whisper's training layer 0, no
    mask, as :func:`capture_train_layer0` recorded it
    (:func:`audio_train_kind`): the encoder's self-attention and the
    cross-attention.  Wrong controls: the causal mask applied; for the
    cross-attention Skv taken as Sq (the first Sq frames only); and the
    ragged last 128-key block dropped.  Attention over 1,500 random frames
    is near uniform, so the last control runs on the same inputs with the
    last frame planted on every query (:func:`plant_last_frame`), where
    the kernel is held again and the control must fail in dq too; the
    unplanted share of dq is recorded.  Returns {kind: {kernel:
    record}}."""
    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref, mha_ref

    tol = ATTN_TOL["bfloat16"]
    kw = dict(causal=False, window=0)
    out = {}
    for kind in AUDIO_TRAIN_KINDS:
        need(kind in shapes, f"audio train: no {kind} backward recorded")
        q, k, v, o, lse, do, _ = call = shapes[kind]
        Sq, Skv = q.shape[1], k.shape[1]
        need((Sq == Skv) == (kind == "encoder"),
             f"audio train {kind}: q {tuple(q.shape)}, k {tuple(k.shape)}")
        name = f"audio train {kind}, layer 0"
        fwd_controls = {"the causal mask applied": lambda q, k, v: mha_ref(
            q, k, v, causal=True)}
        bwd_wrong = {"the causal mask applied": lambda f: mha_bwd_ref(
            *f, causal=True)}
        if kind == "cross":
            fwd_controls["Skv taken as Sq"] = lambda q, k, v: mha_ref(
                q, k[:, :Sq], v[:, :Sq], **kw)
            bwd_wrong["Skv taken as Sq"] = lambda f: padded_keys_bwd(
                f[0], f[1], f[2], f[5], Sq, **kw)
        rec, got, f = train_attention_check(call, name, fwd_controls,
                                            bwd_wrong)
        keep = Skv - (Skv % 128 or 128)
        need(keep > 0, f"{name}: {Skv} frames leave no whole 128-key block")
        unplanted_dq = bwd_shares(got, padded_keys_bwd(
            f[0], f[1], f[2], f[5], keep, **kw), tol)[0]
        # the last frame planted on every query: the kernel held again,
        # and the ragged last key block dropped must fail there, in dq too
        qp, kp = plant_last_frame(q, k, gen)
        op, lsep = flash_attention_cuda(qp, kp, v, return_lse=True, **kw)
        gotp = flash_attention_bwd_cuda(qp, kp, v, op, lsep, do, **kw)
        fp = [t.float() for t in (qp, kp, v, op)] + [lsep, do.float()]
        perr, pused = grad_compare(gotp, mha_bwd_ref(*fp, **kw), tol,
                                   f"{name} backward, last frame planted")
        cname = f"the ragged last key block (keys past {keep}) dropped"
        shares = bwd_shares(gotp, padded_keys_bwd(
            fp[0], fp[1], fp[2], fp[5], keep, **kw), tol)
        need(max(shares) > 1.0 and shares[0] > 1.0,
             f"{name} backward, last frame planted: the control '{cname}' "
             f"stays within the limit ({max(shares):.3g}x, dq "
             f"{shares[0]:.3g}x)")
        b = rec["flash_attention_bwd_cuda"]
        b["controls_limit_used"][cname + ", last frame planted"] = max(shares)
        b.update(max_abs_err=max(b["max_abs_err"], perr),
                 limit_used=max(b["limit_used"], pused),
                 planted_limit_used=pused,
                 planted_dq_control_limit_used=shares[0],
                 unplanted_dq_control_limit_used=unplanted_dq)
        log(f"  audio train {kind} layer 0: {json.dumps(rec)}")
        out[kind] = rec
        del got, gotp, f, fp, qp, kp, op, lsep
    return out


def audio_train_path(cfg, card, device="cuda", log=print):
    """Phase 11c: whisper-medium training at full width and depth through
    ``make_train_step`` (AUDIO_TRAIN_STEPS steps of AUDIO_TRAIN_CLIPS
    clips and AUDIO_TRAIN_TEXT-token transcripts; a ``cuts`` line names
    what is cut).  Every loss and gradient norm finite, no step skipped;
    the attention wrappers called as :func:`audio_train_launches` implies
    and, on the card, every launch of kernel 3 and of the backward on
    AUDIO_TRAIN_ROUTE.  Then one more step under ``torch.profiler`` with
    the peak memory, one ``AsyncCheckpointer`` snapshot of the state
    restored bit for bit (:func:`checkpoint_round_trip`), and the no-mask
    calls at layer 0 against their plain versions
    (:func:`audio_train_attention_check`).  Returns the run's record, its
    launches by route and the layer-0 records."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.models import init_model_params
    from repro_torch.models.model import flat_leaves
    from repro_torch.train.data import SyntheticLMDataset
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    need(cfg.family == "audio" and cfg.dtype == "bfloat16"
         and cfg.param_dtype == "float32" and cfg.remat == "full",
         f"audio train: {cfg.name} is not bf16 compute over float32 "
         f"masters with full remat")
    B, S, F = AUDIO_TRAIN_CLIPS, AUDIO_TRAIN_TEXT, cfg.encoder_seq_len
    log("audio_train cuts: " + json.dumps(AUDIO_TRAIN_CUTS) + f" ({cfg.name}"
        f": {cfg.encoder_layers} encoder and {cfg.num_layers} decoder "
        f"layers at d_model {cfg.d_model}, {B} clips of {F} frames and "
        f"{S} tokens a step, {AUDIO_TRAIN_STEPS} steps)")
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=AUDIO_TRAIN_STEPS)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model_params(cfg, torch.Generator(device=device).manual_seed(
        0), device=device, trainable=True)
    opt_state = init_opt_state(flat_leaves(model)[0], oc)
    n_params = sum(p.numel() for p in flat_leaves(model)[0])
    step_fn = make_train_step(cfg, oc)
    data = SyntheticLMDataset(cfg.vocab_size, S, B, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)

    def batch_at(step):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch_at(step).items()}
        batch["frames"] = torch.randn(B, F, cfg.d_model, generator=gen,
                                      device=device)
        return batch

    t_init = time.perf_counter() - t0
    reset_attn_launches()
    steps, shapes = [], {}
    with counted_attention() as calls:
        for step in range(AUDIO_TRAIN_STEPS):
            batch = batch_at(step)
            t = time.perf_counter()
            if step == 0:
                with capture_train_layer0(audio_train_kind) as shapes:
                    model, opt_state, m = step_fn(model, opt_state, batch)
            else:
                model, opt_state, m = step_fn(model, opt_state, batch)
            m = {k: float(m[k]) for k in ("loss", "ce", "grad_norm", "lr",
                                          "skipped")}
            steps.append({"step": step, **m,
                          "seconds": time.perf_counter() - t})
    if cuda:
        torch.cuda.synchronize()
    flash_routes = dict(flash_attention_cuda.launches_by_route)
    bwd_routes = dict(flash_attention_bwd_cuda.launches_by_route)
    launches = {"flash_attention_cuda": flash_attention_cuda.launches,
                "flash_attention_bwd_cuda": flash_attention_bwd_cuda.launches}
    for s_ in steps:
        s_["tokens_per_s"] = B * S / s_["seconds"]
    rec = {"arch": cfg.name, "encoder_layers": cfg.encoder_layers,
           "decoder_layers": cfg.num_layers, "params": n_params,
           "clips": B, "frames": F, "text_tokens": S,
           "seconds_init": t_init, "steps": steps,
           "wrapper_calls": dict(calls), "launches": launches,
           "flash_launches_by_route": flash_routes,
           "bwd_launches_by_route": bwd_routes, "card": card}
    if cuda:
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase audio_train: {json.dumps(rec)}")
    need(n_params == schema_leaves(cfg), f"audio train: {n_params} "
         f"parameters, not the schema's {schema_leaves(cfg)}")
    need(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
             for h in steps), "audio train: a non-finite loss or gradient "
                              "norm")
    need(not any(h["skipped"] for h in steps),
         "audio train: a step was skipped")
    n_fwd, n_bwd = (n * AUDIO_TRAIN_STEPS for n in audio_train_launches(cfg))
    need(dict(calls) == {"flash_attention_cuda": n_fwd,
                         "flash_attention_bwd_cuda": n_bwd},
         f"audio train: the attention wrappers were called {dict(calls)}, "
         f"not {n_fwd} and {n_bwd} times")
    if cuda:
        need(flash_routes == {r: n_fwd * (r == AUDIO_TRAIN_ROUTE)
                              for r in flash_routes},
             f"audio train: kernel 3's launches took the routes "
             f"{flash_routes}, not {n_fwd} {AUDIO_TRAIN_ROUTE}")
        need(bwd_routes == {r: n_bwd * (r == AUDIO_TRAIN_ROUTE)
                            for r in bwd_routes},
             f"audio train: the backward's launches took the routes "
             f"{bwd_routes}, not {n_bwd} {AUDIO_TRAIN_ROUTE}")

    # where a step's time goes, and its peak memory
    batch = batch_at(AUDIO_TRAIN_STEPS)
    prof = profile_window("step", lambda: step_fn(model, opt_state, batch),
                          log, phase="audio_train_profile")
    rec["profile"] = {k: prof.get(k) for k in ("wall_ms", "device_ms",
                                               "idle_share", "peak_GB")}
    rec["checkpoint"] = checkpoint_round_trip(model, opt_state,
                                              "audio_train", log)
    del model, opt_state, batch
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["attention_check"] = audio_train_attention_check(shapes, gen, log)
    log(f"phase audio_train_attention_check: "
        f"{json.dumps({'seconds': time.perf_counter() - t0})}")
    return {"train": rec, "launches": launches, "shapes": shapes,
            "routes": {"flash_attention_cuda": flash_routes,
                       "flash_attention_bwd_cuda": bwd_routes}}


def audio_train_timing(shapes, rate, card, log=print):
    """The backward at whisper's two no-mask training shapes (layer 0's
    inputs, :func:`capture_train_layer0`), on the card, beside SDPA's
    flash backward without a mask (d 64, MHA;
    ``aten._scaled_dot_product_flash_attention_backward`` over its own
    forward's output and log-sum-exp), which computes the same function
    and is first held within :func:`grad_limit` against the plain
    version on those inputs.  Both sides by the same three methods:
    CUDA-graph replay (``ms`` and ``library_ms``), eager calls (``eager_ms``,
    ``library_eager_ms``) and their kernels' device time under the
    profiler (``launch_ms``, the kernel's three launches apart,
    :func:`bwd_launch_ms`, and ``library_device_ms``).  Also the plain
    version's ms and the bound: the larger of the bytes moved over
    ``rate`` and 10·d operations a visible pair over BF16_RATE.  Returns
    {kind: record}."""
    import torch

    from repro_torch.kernels.flash_attention.bwd import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_bwd_ref

    aten = torch.ops.aten
    out = {}
    for kind in AUDIO_TRAIN_KINDS:
        q, k, v, o, lse, do, _ = shapes[kind]
        B, Sq, H, d = q.shape
        Skv = k.shape[1]
        pairs = B * H * Sq * Skv
        moved = sum(t.numel() * t.element_size()
                    for t in (q, k, v, o, lse, do, q, k, v))
        t_bytes, t_ops = moved / rate, 10 * d * pairs / BF16_RATE

        def kern():
            return flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=False)

        # SDPA's layout (B, H, S, d): views of the same tensors
        qx, kx, vx, dox = (t.transpose(1, 2) for t in (q, k, v, do))
        (sd_o, sd_lse, cum_q, cum_k, max_q, max_k, seed, offset,
         _) = aten._scaled_dot_product_flash_attention(qx, kx, vx, 0.0,
                                                       False)

        def sdpa_bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                dox, qx, kx, vx, sd_o, sd_lse, cum_q, cum_k, max_q, max_k,
                0.0, False, seed, offset)

        # held on its own forward's output and log-sum-exp: dQ hangs on
        # D = rowsum(dO o), so another o's bf16 rounding moves it
        want = mha_bwd_ref(*[t.float() for t in (
            q, k, v, sd_o.transpose(1, 2))], sd_lse[..., :Sq].float(),
            do.float(), causal=False)
        grad_compare([g.transpose(1, 2) for g in sdpa_bwd()], want,
                     ATTN_TOL["bfloat16"], f"audio train {kind}: SDPA's "
                                           f"flash backward")
        del want
        rec = {"call": f"audio train {kind}, layer 0 (B={B}, Sq={Sq}, "
                       f"Skv={Skv}, H={H}, d={d}, no mask)",
               "ms": cuda_ms(kern, reps=10),
               "launch_ms": bwd_launch_ms(kern),
               "eager_ms": cuda_ms(kern, reps=10, graph=False),
               "plain_ms": cuda_ms(lambda: mha_bwd_ref(
                   q, k, v, o, lse, do, causal=False), reps=2, warm=1,
                   graph=False),
               "library_ms": cuda_ms(sdpa_bwd, reps=10),
               "library_eager_ms": cuda_ms(sdpa_bwd, reps=10, graph=False),
               "library_device_ms": sum(profiled_device_ms(
                   sdpa_bwd).values()),
               "library": "SDPA flash backward "
                          "(aten._scaled_dot_product_flash_attention_"
                          "backward), no mask",
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "flop": 10 * d * pairs, "pairs": pairs,
               "card": card}
        log(f"  flash_attention_bwd_cuda audio train {kind}: "
            f"{json.dumps(rec)}")
        out[kind] = rec
        del sd_o, sd_lse
    torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"HBM rate for bounds {rate / 1e12} TB/s")
    torch.backends.cuda.matmul.allow_tf32 = False  # library yardstick: fp32

    # 2. build
    from repro_torch.kernels import _build

    _build.library(verbose=True)
    print(f"phase build: {json.dumps({'seconds': _build.build_seconds})}")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "warning")):
            print("  ptxas:", line.strip())

    # 3. kernels against plain versions
    t0 = time.perf_counter()
    n = kernel_sweep("cuda")
    print(f"phase kernel_sweep: {json.dumps({'seconds': time.perf_counter() - t0, 'comparisons': n})}")

    # 4. the attention kernels against their plain versions
    t0 = time.perf_counter()
    n = attention_sweep("cuda")
    print(f"phase attention_sweep: {json.dumps({'seconds': time.perf_counter() - t0, 'comparisons': n})}")

    # 5. the graph main path, launches counted
    from repro_torch.configs.goffish_tr import TR_SMALL
    from repro_torch.kernels.semiring_spmm.kernel import spmv_blocked_cuda
    from repro_torch.kernels.semiring_superstep.kernel import fused_step_cuda

    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    reset_attn_launches()
    w0 = walk_counts()
    with call_shapes() as shape_launches:
        keep = main_path(TR_SMALL, "cuda")
    launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                "fused_step_cuda": fused_step_cuda.launches}
    walks = {"main": check_walks("main path", shape_launches, w0,
                                 walk_counts())}
    print(f"main path launches: {json.dumps(launches)}")
    print("main path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(shape_launches.items())}))
    print(f"main path launches by walk: {json.dumps(walks['main'])}")
    for k, v in launches.items():
        need(sum(n for (kk, _), n in shape_launches.items() if kk == k)
             == v, f"{k}: launches by call shape do not sum to {v}")
    print(f"main path cuts: {json.dumps(keep['cut'])} (dense phases run "
          f"all {TR_SMALL.num_instances} instances)")
    for k, v in launches.items():
        need(v > 0, f"{k} was not launched on the main path")
    print(f"peak device memory GB: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    # 5b. the query axis over phase 5's staged batch, launches counted
    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    w0 = walk_counts()
    with call_shapes() as query_shapes:
        query = query_phase(keep, "cuda")
    query_launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                      "fused_step_cuda": fused_step_cuda.launches}
    walks["query"] = check_walks("query path", query_shapes, w0,
                                 walk_counts())
    print(f"query path launches by walk: {json.dumps(walks['query'])}")
    for k, v in walks["query"].items():
        need(v["lane_walk"] > 0, f"{k}: no launch on the lane walk on the "
                                 f"query path")
    print(f"phase query: {json.dumps({'seconds': time.perf_counter() - t0})}")
    print(f"query path launches: {json.dumps(query_launches)}")
    print("query path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(query_shapes.items())}))
    for k, v in query_launches.items():
        need(sum(n for (kk, _), n in query_shapes.items() if kk == k)
             == v, f"{k}: query launches by call shape do not sum to {v}")
        need(any(n > 0 for (kk, c), n in query_shapes.items()
                 if kk == k and c.endswith(f" Q={QUERY_LANES}")),
             f"{k} was not launched in its Q-lane form on the query path")

    # 5d. the four examples at their own sizes, asserts live
    t0 = time.perf_counter()
    examples = examples_phase("cuda")
    print(f"phase examples: {json.dumps({'seconds': time.perf_counter() - t0})}")

    # 6. the graph path from a GoFS deployment, launches counted
    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    w0 = walk_counts()
    with call_shapes() as gofs_shapes:
        gofs = gofs_path(TR_SMALL, keep, "cuda", card=card)
    gofs_launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                     "fused_step_cuda": fused_step_cuda.launches}
    walks["gofs"] = check_walks("gofs path", gofs_shapes, w0, walk_counts())
    print(f"gofs path launches by walk: {json.dumps(walks['gofs'])}")
    print(f"phase gofs_path: {json.dumps({'seconds': time.perf_counter() - t0})}")
    print(f"gofs path launches: {json.dumps(gofs_launches)}")
    # 6d's launches are counted in its rank processes (their counts start
    # at 0 with the process), apart from this process's
    mesh = gofs["mesh"]
    walks["mesh"] = {k: {w: sum(r[k][w] for r in mesh["launches_by_walk"])
                         for w in mesh["launches_by_walk"][0][k]}
                     for k in mesh["launches_by_walk"][0]}
    print(f"mesh path launches by walk: {json.dumps(walks['mesh'])}")
    print("gofs path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(gofs_shapes.items())}))
    print(f"gofs path cuts: {json.dumps(gofs['cut'])} (TR_SMALL: "
          f"{TR_SMALL.num_instances} instances)")
    for k, v in gofs_launches.items():
        need(sum(n for (kk, _), n in gofs_shapes.items() if kk == k) == v,
             f"{k}: GoFS-path launches by call shape do not sum to {v}")
        need(v > 0, f"{k} was not launched on the GoFS path")

    # 6b. streaming ingestion and warm serving, launches counted
    for k in (spmv_blocked_cuda, fused_step_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    w0 = walk_counts()
    with call_shapes() as stream_shapes:
        stream = stream_phase(TR_SMALL, keep, card, "cuda")
    stream_launches = {"spmv_blocked_cuda": spmv_blocked_cuda.launches,
                       "fused_step_cuda": fused_step_cuda.launches}
    walks["stream"] = check_walks("stream path", stream_shapes, w0,
                                  walk_counts())
    print(f"stream path launches by walk: {json.dumps(walks['stream'])}")
    print(f"phase stream: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    print(f"stream path launches: {json.dumps(stream_launches)}")
    print("stream path launches by call shape: " + json.dumps(
        {f"{k} {c}": n for (k, c), n in sorted(stream_shapes.items())}))
    print(f"stream path cuts: {json.dumps(stream['cut'])} (TR_SMALL: "
          f"{TR_SMALL.num_instances} instances; the grown collection's "
          f"last {2 * STREAM_APPEND} appended)")
    for k, v in stream_launches.items():
        need(sum(n for (kk, _), n in stream_shapes.items() if kk == k) == v,
             f"{k}: stream-path launches by call shape do not sum to {v}")
        need(v > 0, f"{k} was not launched on the stream path")
        need(any(n > 0 for (kk, c), n in stream_shapes.items()
                 if kk == k and " Q=" not in c),
             f"{k}: no one-lane (tail) launch on the stream path")
    for lanes in (QUERY_LANES, 4):
        need(any(n > 0 for (kk, c), n in stream_shapes.items()
                 if kk == "spmv_blocked_cuda" and c.endswith(f" Q={lanes}")),
             f"spmv_blocked_cuda: no Q={lanes} launch on the stream path")
    keep.pop("in_memory")
    keep.pop("session_held")
    torch.cuda.empty_cache()

    # 7. the graph kernels at the main path's shapes
    t0 = time.perf_counter()
    report = kernel_report(keep, launches, shape_launches, query_shapes, card,
                           rate, cluster=gofs["cluster"])
    for rec in report:
        k = rec["name"]
        rec["query_launches"] = query_launches[k]
        rec["query_launches_by_call_shape"] = {
            c: n for (kk, c), n in sorted(query_shapes.items()) if kk == k}
        rec["query"] = {m: {key: query[m][key] for key in (
            "seconds", "launches", "host_syncs", "slowest_lane_launches",
            "sum_over_lanes_launches")} for m in ("spmv", "fused")}
        rec["query"]["single_source_runs"] = query["single_source_runs"]
        rec["launches_by_walk"] = {path: w[k] for path, w in walks.items()}
        rec["gofs_launches"] = gofs_launches[k]
        rec["gofs_launches_by_call_shape"] = {
            c: n for (kk, c), n in sorted(gofs_shapes.items()) if kk == k}
        # the session's launches are a part of the GoFS path's
        rec["session_launches"] = gofs["session"]["launches"][k]
        rec["session_launches_by_call_shape"] = {
            c[len(k) + 1:]: n for c, n in
            gofs["session"]["launches_by_call_shape"].items()
            if c.startswith(k + " ")}
        # the cluster workers' launches (phase 6c), summed over workers
        rec["cluster_launches"] = gofs["cluster"]["launches"][k]
        rec["cluster_launches_by_call_shape"] = {
            c[len(k) + 1:]: n for c, n in
            sorted(gofs["cluster"]["launches_by_call_shape"].items())
            if c.startswith(k + " ")}
        rec["mesh_launches"] = mesh["launches"][k]
        rec["mesh_launches_by_call_shape"] = {
            c[len(k) + 1:]: n for c, n in
            sorted(mesh["launches_by_call_shape"].items())
            if c.startswith(k + " ")}
        rec["stream_launches"] = stream_launches[k]
        rec["stream_launches_by_call_shape"] = {
            c: n for (kk, c), n in sorted(stream_shapes.items()) if kk == k}
    print(f"phase kernel_timing: {json.dumps({'seconds': time.perf_counter() - t0})}")
    del keep
    torch.cuda.empty_cache()

    # 8. the LM serving path, launches counted (inside serve_path)
    lm = serve_path("cuda")
    launches.update(lm["launches"])
    serve_profile(lm, "cuda")
    # 9. teacher forcing: the flash kernel against the decode kernel
    teacher_forcing(lm, "cuda")
    # 10. the attention kernels at the serving run's and the 32k shapes
    shapes = lm.pop("shapes")
    routes = lm.pop("routes")
    lm.clear()
    torch.cuda.empty_cache()
    # 8b. the MoE family serving, launches counted (inside moe_serve_one)
    t0 = time.perf_counter()
    moe_recs = moe_serve(moe_cut_configs(), card, "cuda")
    print(f"phase moe_serve: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    # 8c. the audio family serving, launches counted (inside audio_serve),
    # then its five layer-0 calls timed
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    audio_cfg = get_config(AUDIO_ARCH)
    print(f"audio path cuts: {{}} ({audio_cfg.name} at full width and "
          f"depth: {audio_cfg.encoder_layers} encoder and "
          f"{audio_cfg.num_layers} decoder layers)")
    audio = audio_serve(audio_cfg, card, "cuda")
    audio_timing(audio["calls"], rate)
    print(f"phase audio: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    report += attention_report(shapes, launches, routes, card, rate)
    audio_rows = {"flash_attention_cuda": AUDIO_CALLS[:3],
                  "decode_attention_cuda": AUDIO_CALLS[3:]}
    for rec in report:  # the audio phase's launches and calls
        calls = audio_rows.get(rec["name"])
        if calls:
            rec["audio_launches"] = {
                "launches": audio["launches"][rec["name"]],
                "by_route": audio["launches_by_route"][rec["name"]]}
            rec["audio_calls"] = {c: audio["calls"][c] for c in calls}
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                audio["calls"][c]["max_abs_err"] for c in calls])
            rec["limit_used"] = max([rec["limit_used"]] + [
                audio["calls"][c]["limit_used"] for c in calls])
    for rec in report:  # the MoE phase's launches, by model
        if rec["name"] in ("flash_attention_cuda", "decode_attention_cuda"):
            rec["moe_launches"] = {
                a: {"launches": r["launches"][rec["name"]],
                    "by_route": r["launches_by_route"][rec["name"]]}
                for a, r in moe_recs.items()}
            rec["moe_calls"] = {a: r["attention_check"][rec["name"]]
                                for a, r in moe_recs.items()}
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                c["max_abs_err"] for c in rec["moe_calls"].values()])
            rec["limit_used"] = max([rec["limit_used"]] + [
                c["limit_used"] for c in rec["moe_calls"].values()])
    # 11. LM training, launches counted (inside train_path), then the
    # backward kernel against its plain version and timed
    t0 = time.perf_counter()
    train = train_path(card, "cuda")
    print(f"phase train_path: {json.dumps({'seconds': time.perf_counter() - t0})}")
    bwd_row, flash_train = train_kernel_report(train, card, rate)
    for rec in report:
        if rec["name"] == "flash_attention_cuda":
            rec.update(flash_train)
    report.append(bwd_row)
    # 11b. MoE training, launches counted (inside moe_train_one)
    t0 = time.perf_counter()
    moe_train = moe_train_path(moe_train_configs(), card, "cuda")
    print(f"phase moe_train: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    for rec in report:  # the MoE training launches, by model
        if rec["name"] in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
            rec["moe_train_launches"] = {
                a: {"launches": r["launches"][rec["name"]],
                    "by_route": r["launches_by_route"][rec["name"]]}
                for a, r in moe_train.items()}
            rec["moe_train_calls"] = {a: r["attention_check"][rec["name"]]
                                      for a, r in moe_train.items()}
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                c["max_abs_err"] for c in rec["moe_train_calls"].values()])
            rec["limit_used"] = max([rec["limit_used"]] + [
                c["limit_used"] for c in rec["moe_train_calls"].values()])
    # 11c. whisper-medium training, launches counted (inside
    # audio_train_path), then the backward at its no-mask shapes timed
    t0 = time.perf_counter()
    audio_train = audio_train_path(get_config(AUDIO_ARCH), card, "cuda")
    audio_train["timing"] = audio_train_timing(audio_train.pop("shapes"),
                                               rate, card)
    print(f"phase audio_train_path: {json.dumps({'seconds': time.perf_counter() - t0, 'card': card})}")
    for rec in report:  # the audio training launches and layer-0 calls
        if rec["name"] in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
            rec["audio_train_launches"] = {
                "launches": audio_train["launches"][rec["name"]],
                "by_route": audio_train["routes"][rec["name"]]}
            calls = {kind: dict(c[rec["name"]]) for kind, c in
                     audio_train["train"]["attention_check"].items()}
            if rec["name"] == "flash_attention_bwd_cuda":
                for kind, t in audio_train["timing"].items():
                    calls[kind].update(t)
            rec["audio_train_calls"] = calls
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                c["max_abs_err"] for c in calls.values()])
            rec["limit_used"] = max([rec["limit_used"]] + [
                c["limit_used"] for c in calls.values()])
    for rec in report:  # the examples phase's launches of each kernel
        rec.setdefault("mesh_launches", 0)  # attention: not on the mesh
        rec["examples_launches"] = {
            name: e["launches"].get(rec["name"], 0)
            for name, e in examples.items()}
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] == ["--cluster-worker"]:
        sys.exit(cluster_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--mesh-worker"]:
        code = mesh_worker(json.loads(sys.argv[2]))
        # the process group's C++ threads can abort the interpreter's own
        # teardown ("terminate called without an active exception"): the
        # rank's record is written, so leave without it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(main())
