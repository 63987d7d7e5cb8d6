"""Graph analytics on a mesh, one process a rank (the port's multi-GPU
placement; ``repro_torch.launch.mesh``).

Under ``torchrun``, every rank runs the same session calls on the same
collection and gets the global result; rank 0 prints it::

  torchrun --standalone --nproc-per-node=2 -m repro_torch.launch.mesh_graph \\
      --data 1 --model 2                 # nccl, one GPU a rank
  torchrun --standalone --nproc-per-node=4 -m repro_torch.launch.mesh_graph \\
      --data 2 --model 2 --backend gloo --device cpu --check

Rank 0 prints the plan and a JSON record (seconds of the pass, its
staged bytes and the exchange's counters on rank 0).  ``--check`` also
runs the stacked session on rank 0 (``stacked_seconds``) and requires
SSSP bitwise and PageRank within rtol 1e-6 (``parity OK``).  Several
ranks on ONE card need ``--backend gloo`` (NCCL refuses two ranks on a
device).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=1,
                    help="ranks on the data dim (instances)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the model dim (partitions)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--size", default="tiny", choices=("tiny", "small"),
                    help="TR_TINY or TR_SMALL (configs/goffish_tr.py)")
    ap.add_argument("--comm", default=None,
                    choices=("dense", "ring", "ring-rs"),
                    help="override the planned boundary exchange")
    ap.add_argument("--iters", type=int, default=10,
                    help="PageRank iterations")
    ap.add_argument("--check", action="store_true",
                    help="also run the stacked session on rank 0 and "
                         "require parity")
    return ap


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.goffish_tr import TR_SMALL, TR_TINY
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.comm import exchange_stats, reset_exchange_stats
    from repro_torch.core.generator import generate_collection
    from repro_torch.core.partition import partition_graph
    from repro_torch.gopher import GopherSession
    from repro_torch.launch.mesh import init_mesh

    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        import os

        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % max(1, torch.cuda.device_count()))
    mesh = init_mesh(args.data, args.model, backend=args.backend,
                     device=dev)
    rank = dist.get_rank()
    cfg = {"tiny": TR_TINY, "small": TR_SMALL}[args.size]
    col = generate_collection(cfg)
    t = col.template
    bg = build_blocked(t, partition_graph(t, cfg.num_partitions,
                                          seed=cfg.seed), cfg.block_size)
    weights = {a: np.stack([col.edge_values(i, a) for i in range(len(col))])
               for a in ("latency", "active")}

    def session(**kw):
        return GopherSession.from_blocked(bg, weights=weights, src=t.src,
                                          dst=t.dst, device=dev, **kw)

    sess = session(mesh=mesh)
    plans = [sess.plan("sssp", source=0, comm=args.comm),
             sess.plan("pagerank", iters=args.iters, comm=args.comm)]

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_exchange_stats()
    got, seconds = timed(lambda: sess.run_many(plans))
    rec = {"ranks": dist.get_world_size(), "mesh": plans[0].placement.value,
           "comm": plans[0].comm.value, "backend": args.backend,
           "seconds": seconds, "exchange": exchange_stats(),
           "staged_bytes": sess.last_run_report["staged_bytes"],
           "sssp_reached": int(np.isfinite(got[0].output["final"]).sum()),
           "sssp_supersteps": int(np.sum(got[0].engine.stats["supersteps"])),
           "pagerank_top_vertex": int(got[1].output["ranks"][0].argmax())}
    ok = True
    dist.barrier()  # no rank closes its connections with messages in flight
    if rank == 0:
        print(plans[0].explain())
        if args.check:
            one = session()
            want, rec["stacked_seconds"] = timed(lambda: one.run_many(
                [one.plan(p.analytic, **p.param_dict) for p in plans]))
            a, b = got[0].engine, want[0].engine
            ok = (a.values.tobytes() == b.values.tobytes()
                  and np.array_equal(a.stats["supersteps"],
                                     b.stats["supersteps"])
                  and np.allclose(got[1].engine.values, want[1].engine.values,
                                  rtol=1e-6, atol=0))
        print(json.dumps(rec))
        if args.check:
            print("parity OK" if ok else "parity FAILED")
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    import os
    import sys

    code = main()
    # the process group's C++ threads can abort the interpreter's own
    # teardown ("terminate called without an active exception"): the
    # work is done and printed, so leave without it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
