"""End-to-end LM training on the port with checkpoint/restart (counterpart
of ``examples/train_lm.py``), demonstrating the fault-tolerance contract:
a kill and a resume reproduce the exact stream.

The default is a ~20M model; ``--full`` trains the ~100M configuration.
Both run on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--full]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

Weights are random, drawn from a seeded ``torch.Generator`` on the device;
the batches are the reference example's (``SyntheticLMDataset``).
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.superstep import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.train.optimizer import OptConfig


def main(device="cuda", steps: int = 200, batch: int = 8, seq: int = 128,
         full: bool = False) -> None:
    dev = resolve_device(device)
    if full:  # ~100M params: glm4 geometry scaled to d=768/12L
        cfg = get_config("glm4-9b").with_overrides(
            num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32_768, max_seq_len=512,
            remat="none",
        )
    else:  # ~20M
        cfg = get_config("glm4-9b").with_overrides(
            num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
            head_dim=64, d_ff=1024, vocab_size=16_384, max_seq_len=512,
            remat="none",
        )
    n_params = cfg.param_count()
    print(f"model: {n_params/1e6:.0f}M params "
          f"({cfg.num_layers}L d={cfg.d_model})")

    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_ckpt_")
    oc = OptConfig(lr=6e-4, warmup_steps=20, total_steps=steps)
    try:
        print(f"== phase 1: train to step {steps // 2}, checkpoint, 'crash'")
        out1 = train_loop(
            cfg, steps=steps // 2, global_batch=batch, seq_len=seq,
            device=dev, oc=oc, ckpt_dir=ckpt_dir, ckpt_every=steps // 4,
            log_every=20,
        )
        print("== phase 2: restart from checkpoint, finish the run")
        out2 = train_loop(
            cfg, steps=steps, global_batch=batch, seq_len=seq, device=dev,
            oc=oc, ckpt_dir=ckpt_dir, ckpt_every=steps // 4, log_every=20,
        )
        assert out2["resumed_from"] is not None, "must resume, not restart"
        first = out1["history"][0]["loss"]
        last = out2["history"][-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f} "
              f"(resumed from step {out2['resumed_from']})")
        assert last < first - 0.5, "training must reduce loss"
        print("✓ end-to-end train + checkpoint/restart")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="~100M params")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    a = ap.parse_args()
    main(device=a.device, steps=a.steps, batch=a.batch, seq=a.seq,
         full=a.full)
