"""Batched serving example on the port (counterpart of
``examples/serve_lm.py``): prefill + decode over a request queue with a
reduced glm4-9b, through the same step functions that serve the full
model — the flash kernel on prefill and the decode kernel on every step.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm   # on the card
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Weights are random, drawn from a seeded ``torch.Generator`` on the
device; the prompts come from the reference example's numpy stream.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.superstep import resolve_device
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_model_params
from repro_torch.train.serve_step import generate


def main(device="cuda") -> None:
    dev = resolve_device(device)
    cfg = get_config("glm4-9b").reduced()
    model = init_model_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    rng = np.random.default_rng(0)

    # low-level: the generate() loop (greedy)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    toks = generate(model, torch.as_tensor(prompt, device=dev),
                    max_new_tokens=8)
    assert toks.shape == (2, 8)
    print("generate():", toks.cpu().tolist())

    # batched server over a queue
    server = BatchedServer(model, batch_size=4, max_len=64)
    reqs = [
        Request(rid=i,
                tokens=rng.integers(0, cfg.vocab_size,
                                    rng.integers(4, 16)).astype(np.int32),
                max_new=8)
        for i in range(6)
    ]
    done = server.serve(reqs)
    assert len(done) == 6 and all(len(r.out) == 8 for r in done)
    assert server.stats["finite"], "non-finite logits"
    for r in done[:3]:
        print(f"req {r.rid} ({len(r.tokens)} prompt toks) -> {r.out}")
    print("✓ batched serving")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
