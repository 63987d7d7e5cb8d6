"""Training driver (counterpart of ``repro.launch.train``): config -> model
-> train loop with checkpoint/restart, NaN-skip, retry and asynchronous
checkpoints, on one device.

Runs on the card unless asked for the CPU (``--device cpu``); a reduced
config (``--reduced``) trains end to end on either:

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

It prints the reference's lines in the reference's format, and its
checkpoints are the reference's (``{"params", "opt"}`` trees, the same
leaf names and shapes), so a run of either package resumes in the other.
The reference's ``runtime=`` (the mesh) is ``device=`` here; weights come
from a ``torch.Generator`` seeded by ``seed``, not from ``jax.random``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.superstep import resolve_device
from repro_torch.dist.compression import Int8Compressor, TopKCompressor
from repro_torch.models.model import (
    _set_leaf, flat_leaves, init_model_params, opt_state_from_numpy,
    opt_state_to_numpy, params_from_numpy, params_to_numpy, stack_dims,
    train_leaves)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLMDataset
from repro_torch.train.optimizer import (OptConfig, PartialUpdateError,
                                         init_opt_state)
from repro_torch.train.train_step import init_comp_state, make_train_step

COMPRESSORS = ("none", "int8", "topk")


def make_compressor(compress, *, topk_frac: float = 0.01):
    """Resolve the ``--compress`` choice to a gradient compressor.

    Accepts the legacy boolean form (``True`` = int8) and the named
    backends: ``int8`` (symmetric quantization) or ``topk`` (magnitude
    sparsification at ``topk_frac``), both with error feedback
    (``repro_torch.dist.compression``).  Returns ``None`` for no
    compression.
    """
    if compress in (None, False, "none"):
        return None
    if compress in (True, "int8"):
        return Int8Compressor()
    if compress == "topk":
        return TopKCompressor(frac=topk_frac)
    raise ValueError(
        f"unknown compressor {compress!r}; pick from {COMPRESSORS}")


def _like(model) -> Dict[str, Any]:
    """The checkpoint tree's structure, shapes and dtypes, without data
    (``restore`` reads only those from ``like``): each layer leaf stacked
    as the reference's (``stack_dims``: the MoE family's dense layers over
    (groups, moe_every - 1))."""
    tree: Dict[str, Any] = {}
    for name, ts in train_leaves(model):
        shape = stack_dims(model.cfg, name) + tuple(ts[0].shape)
        _set_leaf(tree, name, np.broadcast_to(np.float32(0), shape))
    return {"params": tree,
            "opt": {"mu": tree, "nu": tree, "step": np.int32(0)}}


def _state(model, opt_state) -> Dict[str, Any]:
    return {"params": params_to_numpy(model),
            "opt": opt_state_to_numpy(model, opt_state)}


def train_loop(
    cfg,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    device="cuda",
    oc: Optional[OptConfig] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    keep: int = 3,
    accum_steps: int = 1,
    compress=False,  # False/"none" | True/"int8" | "topk"
    topk_frac: float = 0.01,
    seed: int = 0,
    log_every: int = 10,
    max_step_retries: int = 2,
) -> Dict[str, Any]:
    """Returns {"params", "opt_state", "history", "resumed_from"}:
    ``params`` the trained ``DecoderLM`` (float32 masters), ``opt_state``
    its optimizer state, ``history`` one dict a logged step (the step,
    its metrics and ``seconds``, the wall time since the loop started
    that the log line prints)."""
    dev = resolve_device(device)
    oc = oc or OptConfig(total_steps=steps)
    compressor = make_compressor(compress, topk_frac=topk_frac)
    step_fn = make_train_step(cfg, oc, accum_steps=accum_steps,
                              compressor=compressor)

    model = init_model_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev, trainable=True)
    opt_state = init_opt_state(flat_leaves(model)[0], oc)
    data = SyntheticLMDataset(cfg.vocab_size, seq_len, global_batch,
                              seed=seed)

    start_step = 0
    resumed_from = None
    saver = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep) if ckpt_dir else None
    if ckpt_dir and ckpt.list_steps(ckpt_dir):
        state, start_step = ckpt.restore(ckpt_dir, _like(model))
        del model, opt_state
        model = params_from_numpy(state["params"], cfg, device=dev,
                                  trainable=True)
        opt_state = opt_state_from_numpy(state["opt"], model, oc)
        del state
        resumed_from = start_step
        print(f"[train] resumed from step {start_step}")
    comp_state = init_comp_state(model) if compressor else None

    history = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch_np = data.batch_at(step)  # seekable: exact resume stream
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_np.items()}
        for attempt in range(max_step_retries + 1):
            try:
                if compressor:
                    model, opt_state, metrics, comp_state = step_fn(
                        model, opt_state, batch, comp_state)
                else:
                    model, opt_state, metrics = step_fn(model, opt_state,
                                                        batch)
                break
            except PartialUpdateError:
                raise  # half-applied in place: a retry would apply it twice
            except Exception:  # noqa: BLE001 — transient failure: retry
                if attempt == max_step_retries:
                    raise
                print(f"[train] step {step} failed (attempt {attempt}), "
                      f"retrying")
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"skip={int(m['skipped'])} ({dt:.1f}s)")
            history.append({"step": step, **m, "seconds": dt})
        if saver and (step + 1) % ckpt_every == 0:
            saver.save(step + 1, _state(model, opt_state))
    if saver:
        saver.save(steps, _state(model, opt_state))
        saver.wait()
    return {
        "params": model, "opt_state": opt_state,
        "history": history, "resumed_from": resumed_from,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", nargs="?", const="int8", default="none",
                    choices=COMPRESSORS,
                    help="gradient all-reduce compression (bare flag = "
                         "int8; 'topk' keeps --topk-frac by magnitude "
                         "with error feedback)")
    ap.add_argument("--topk-frac", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    oc = OptConfig(lr=args.lr, total_steps=args.steps,
                   warmup_steps=max(1, args.steps // 10))
    out = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        device=args.device, oc=oc, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, accum_steps=args.accum,
        compress=args.compress, topk_frac=args.topk_frac,
    )
    losses = [h["loss"] for h in out["history"]]
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
