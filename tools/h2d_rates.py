#!/usr/bin/env python3
"""Host-to-device copy rates of the buffers a streamed pass can fill, on
one card.

    python3 tools/h2d_rates.py [--gb 4] [--reps 3]

Times ``dst.copy_(src, non_blocking=True)`` of ``--gb`` GB on a side
stream with CUDA events, from:

* ``pageable``: a plain numpy buffer;
* ``registered``: a numpy buffer page-locked in place with
  ``cudaHostRegister`` (what ``repro_torch.gofs.prefetch.PinnedRing``
  fills);
* ``pinned_alloc``: ``torch.empty(..., pin_memory=True)`` (PyTorch's
  pinned allocator);

each beside the host seconds the ``copy_`` call itself blocks, and the
seconds that pinning the buffer took.  Then the streamed sparse chunk's
pattern: a large registered copy followed by a small pageable
``torch.as_tensor(..., device=)`` on the same stream, timed on the host
(the small copy waits for the large one).  Prints one JSON line per
case and the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("h2d_rates: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    from repro_torch.gofs.prefetch import _pin, _unpin

    n = int(args.gb * 1e9) // 4 * 4
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()

    def timed_copy(src):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(side):
            a.record()
            t0 = time.perf_counter()
            dev.copy_(src, non_blocking=True)
            host_s = time.perf_counter() - t0
            b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3, host_s

    def case(name, make, free=None):
        t0 = time.perf_counter()
        buf = make()
        pin_s = time.perf_counter() - t0
        src = buf if isinstance(buf, torch.Tensor) else torch.from_numpy(buf)
        src.view(torch.uint8)[::4096] = 1  # touch every page
        for rep in range(args.reps):
            dev_s, host_s = timed_copy(src)
            print(json.dumps({"case": name, "rep": rep, "gb": n / 1e9,
                              "device_s": dev_s, "gb_per_s": n / 1e9 / dev_s,
                              "copy_call_host_s": host_s,
                              "prepare_s": pin_s}))
        if free is not None:
            free(buf)

    case("pageable", lambda: np.ones(n, np.uint8))
    case("registered", lambda: _pin(n), _unpin)
    case("pinned_alloc", lambda: torch.empty(n, dtype=torch.uint8,
                                             pin_memory=True))

    # the sparse chunk's pattern: big async copy, then a small blocking one
    buf = _pin(n)
    small = np.arange(1 << 20, dtype=np.int32)
    for rep in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            dev.copy_(torch.from_numpy(buf), non_blocking=True)
            t1 = time.perf_counter()
            torch.as_tensor(small, device="cuda")
            t2 = time.perf_counter()
        print(json.dumps({"case": "registered_then_small_pageable",
                          "rep": rep, "big_call_s": t1 - t0,
                          "small_call_s": t2 - t1,
                          "gb_per_s_implied": n / 1e9 / (t2 - t0)}))
    _unpin(buf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
