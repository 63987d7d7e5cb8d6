"""Gopher CLI: run a time-series graph analytics application over a GoFS
deployment, the paper's end-to-end path (counterpart of
``repro.launch.run_graph``).

  PYTHONPATH=src python -m repro_torch.launch.run_graph --app sssp \
      --size small --source 0                           # on the card
  PYTHONPATH=src python -m repro_torch.launch.run_graph --app sssp \
      --size tiny --device cpu

Apps: sssp (sequential), pagerank (independent), nhop (eventually),
tracking (sequential, Alg. 1), cc (independent).

``--engine blocked`` (the default) runs the engine through the
declarative Gopher session (``repro_torch.gopher``) on ``--device``
(``cuda`` by default): the session reconstructs the blocked structure
straight from the deployed topology slices and auto-selects
layout/comm/staging/kernel — pass ``--comm``/``--layout``/``--staging``
to override a knob, and ``--explain`` to print the chosen plan with its
cost estimates WITHOUT executing anything.  ``--engine host`` runs the
host iBSP engine on the store instead, on the CPU.  ``--deploy``
defaults to a directory under the temporary directory; an existing
deployment there is reused.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_graph_config
from repro_torch.core.algorithms import nhop, pagerank, sssp, tracking
from repro_torch.core.generator import generate_collection
from repro_torch.gofs import GoFSStore, deploy_collection


def default_deploy(name: str) -> str:
    """A deployment directory under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def ensure_deployment(size: str, root: str, cache_slots: int):
    cfg = get_graph_config(size)
    if not os.path.exists(os.path.join(root, "collection.json")):
        print(f"[gopher] deploying {cfg.name} to {root} ...")
        tsg = generate_collection(cfg)
        deploy_collection(tsg, cfg, root)
    return cfg, GoFSStore(
        root, cache_slots=cache_slots,
        vertex_projection=("plate", "outdeg_active"),
        edge_projection=("latency", "active"),
    )


def session_plan(store, cfg, args):
    """Build the declarative session + plan for the chosen app."""
    from repro_torch.gopher import GopherSession

    sess = GopherSession(store, block_size=cfg.block_size,
                         device=args.device)
    knobs = dict(comm=args.comm, layout=args.layout, staging=args.staging)
    if args.app == "sssp":
        plan = sess.plan("sssp", source=args.source, **knobs)
    elif args.app == "pagerank":
        plan = sess.plan("pagerank", iters=10, **knobs)
    elif args.app == "nhop":
        plan = sess.plan("nhop", source=args.source, n_hops=6, **knobs)
    elif args.app == "tracking":
        plan = sess.plan("tracking", plate=args.plate,
                         initial_vertex=args.source, **knobs)
    else:  # cc
        plan = sess.plan("components", **knobs)
    return sess, plan


def report_blocked(app: str, res) -> None:
    out = res.output
    if app == "sssp":
        dist = out["final"]
        ss = res.engine.stats["supersteps"].tolist()
        print(f"[gopher] SSSP reached {int(np.isfinite(dist).sum())}; "
              f"supersteps/timestep={ss}")
    elif app == "pagerank":
        print(f"[gopher] PageRank top vertex (t=0): "
              f"{int(out['ranks'][0].argmax())}")
    elif app == "nhop":
        print(f"[gopher] N-hop composite: {out['composite']}")
    elif app == "tracking":
        print(f"[gopher] track: {out['trace']}")
    else:
        counts = [len(np.unique(lab)) for lab in out["labels"]]
        print(f"[gopher] components per instance: {counts}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--app", default="sssp",
                    choices=["sssp", "pagerank", "nhop", "tracking", "cc"])
    ap.add_argument("--size", default="small",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--deploy", default=default_deploy("gofs_deploy"))
    ap.add_argument("--engine", default="blocked",
                    choices=["blocked", "host"])
    ap.add_argument("--device", default="cuda",
                    help="device of the blocked engine (cuda, or cpu for "
                         "the kernels' plain versions)")
    ap.add_argument("--source", type=int, default=0)
    ap.add_argument("--plate", type=int, default=3)
    ap.add_argument("--cache-slots", type=int, default=14)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--comm", default=None,
                    choices=["dense", "ring", "host"],
                    help="override the planned boundary-exchange backend "
                         "(repro_torch.core.comm; default: planner-selected)")
    ap.add_argument("--layout", default=None, choices=["dense", "sparse"],
                    help="override the planned tile layout")
    ap.add_argument("--staging", default=None, choices=["sync", "async"],
                    help="override the planned staging mode")
    ap.add_argument("--explain", action="store_true",
                    help="print the execution plan (auto-selected knobs + "
                         "cost estimates) and exit without executing")
    args = ap.parse_args(argv)

    cfg, store = ensure_deployment(args.size, args.deploy, args.cache_slots)

    if args.explain:
        sess, plan = session_plan(store, cfg, args)
        print(plan.explain())
        return

    t0 = time.time()
    if args.engine == "host":
        if args.app == "sssp":
            dist, res = sssp.run_host(store, args.source,
                                      workers=args.workers)
            reached = sum(int(np.isfinite(d).sum()) for d in dist.values())
            print(f"[gopher] SSSP reached {reached} vertices; "
                  f"supersteps={res.stats.supersteps} "
                  f"msgs={res.stats.superstep_messages}")
        elif args.app == "pagerank":
            ranks, res = pagerank.run_host(
                store, store.meta["num_vertices"], iters=10,
                workers=args.workers)
            print(f"[gopher] PageRank over {store.num_timesteps()} "
                  f"instances; supersteps={res.stats.supersteps}")
        elif args.app == "nhop":
            merged, res = nhop.run_host(store, args.source, n_hops=6,
                                        workers=args.workers)
            print(f"[gopher] N-hop composite histogram: "
                  f"{merged['composite']}")
        elif args.app == "tracking":
            trace, res = tracking.run_host(store, args.plate, args.source)
            print(f"[gopher] track: {trace}")
        else:
            raise SystemExit("cc requires --engine blocked")
    else:
        sess, plan = session_plan(store, cfg, args)
        print(plan.explain())
        res = sess.run(plan)
        report_blocked(args.app, res)

    print(f"[gopher] {args.app}/{args.engine} done in "
          f"{time.time() - t0:.1f}s; GoFS stats: {store.snapshot_stats()}")


if __name__ == "__main__":
    main()
