"""Serving driver: batched prefill + decode over a request queue
(counterpart of ``repro.launch.serve``).

Serves the dense, MoE and audio families.  On the card, at full width::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
      --requests 4 --prompt-len 8192 --max-new 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --requests 8 --prompt-len 224 --max-new 64 --batch 8

On the CPU, with a reduced config::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \\
      --reduced --device cpu

The audio family (whisper) takes each batch's frame embeddings, the
stub frontend's output (batch, encoder_seq_len, d_model), in
``BatchedServer.extra_inputs["frames"]``; the CLI draws them from its
seed on the device.

A MoE config at full width does not fit one card at its published
depth (dbrx-132b 132B parameters, llama4-maverick 400B); ``chip_smoke.py``
serves both cut in depth (``cfg.with_overrides(num_layers=...)``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.superstep import resolve_device
from repro_torch.models import init_model_params, init_serve_cache
from repro_torch.models.transformer import DecoderLM
from repro_torch.train.serve_step import greedy, make_decode_step, make_prefill_step


@dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (S,)
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Static-batch server: groups requests into fixed (B, S) slots (prompts
    left-padded with token 0, positions 0..S-1 as in the reference), runs
    one prefill per batch, then steps decode until every slot is done.

    ``stats`` accumulates, over all batches: ``prefill_s`` (prefill and the
    first token's read-back) and ``decode_s`` on the host clock (each step
    ends in reading the new tokens, which waits for the device),
    ``tokens`` answered, and ``finite`` (every logit of every step
    finite).  ``extra_inputs`` go to every prefill as they are (the audio
    family's ``frames``, one row a slot)."""

    def __init__(self, model: DecoderLM, *, batch_size: int = 8,
                 max_len: int = 256):
        self.model = model
        self.cfg = model.cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.prefill = make_prefill_step(model)
        self.decode = make_decode_step(model)
        self.stats: Dict[str, float] = {
            "prefill_s": 0.0, "decode_s": 0.0, "tokens": 0, "finite": True}
        self.extra_inputs: Dict[str, Any] = {}

    def _pad_batch(self, reqs: List[Request]) -> torch.Tensor:
        S = max(len(r.tokens) for r in reqs)
        toks = np.zeros((self.batch_size, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.tokens):] = r.tokens  # left-pad
        return torch.as_tensor(toks, device=self.model.device)

    def serve(self, requests: List[Request]) -> List[Request]:
        dev = self.model.device
        t_all = time.perf_counter()
        done: List[Request] = []
        queue = list(requests)
        while queue:
            batch_reqs = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            while len(batch_reqs) < self.batch_size:  # pad with a dummy
                batch_reqs.append(Request(rid=-1, tokens=np.zeros(1, np.int32),
                                          max_new=1))
            toks = self._pad_batch(batch_reqs)
            B, S = toks.shape
            cache = init_serve_cache(self.cfg, B, self.max_len, device=dev)
            t0 = time.perf_counter()
            logits, cache = self.prefill({"tokens": toks, "cache": cache,
                                          **self.extra_inputs})
            finite = torch.isfinite(logits).all()
            nxt = greedy(logits)
            for r, t in zip(batch_reqs, nxt.tolist()):
                r.out.append(t)
            t1 = time.perf_counter()
            max_new = max(r.max_new for r in batch_reqs)
            for step in range(max_new - 1):
                pos = torch.full((B,), S + step, dtype=torch.int32, device=dev)
                nxt, logits, cache = self.decode(
                    {"tokens": nxt[:, None], "pos": pos, "cache": cache})
                finite = finite & torch.isfinite(logits).all()
                for r, t in zip(batch_reqs, nxt.tolist()):
                    if len(r.out) < r.max_new:
                        r.out.append(t)
            self.stats["finite"] = self.stats["finite"] and bool(finite)
            self.stats["prefill_s"] += t1 - t0
            self.stats["decode_s"] += time.perf_counter() - t1
            for r in batch_reqs:
                if r.rid >= 0:
                    r.done = True
                    done.append(r)
        dt = time.perf_counter() - t_all
        n_tok = sum(len(r.out) for r in done)
        self.stats["tokens"] += n_tok
        print(f"[serve] {len(done)} requests, {n_tok} tokens, {dt:.1f}s "
              f"({n_tok / max(dt, 1e-9):.1f} tok/s)")
        return done


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_model_params(cfg, gen, device=dev)
    server = BatchedServer(model, batch_size=args.batch,
                           max_len=args.prompt_len + args.max_new + 8)
    if cfg.family == "audio":  # the reference feeds zeros
        server.extra_inputs["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                tokens=rng.integers(0, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    done = server.serve(reqs)
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
