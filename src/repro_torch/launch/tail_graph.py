"""Live-tailing CLI: streaming ingestion into a served GoFS collection
(counterpart of ``repro.launch.tail_graph``).

  PYTHONPATH=src python -m repro_torch.launch.tail_graph --size small \
      --prefix 4 --batch 2 --analytic sssp --fresh      # on the card
  PYTHONPATH=src python -m repro_torch.launch.tail_graph --size tiny \
      --prefix 1 --fresh --device cpu

Deploys a PREFIX of the configured collection, starts a
:class:`~repro_torch.gopher.GopherService` on ``--device`` (``cuda`` by
default) with a tailing subscription (:meth:`GopherService.subscribe`),
then streams the remaining instances into the deployment from a feeder
thread (:func:`~repro_torch.gofs.append_instances`) — the serve loop
observes each append at a batch boundary and delivers one warm
incremental :class:`~repro_torch.gopher.session.TailUpdate` per append.
Prints each update's mode/latency and finishes with an exactness check
against a cold full re-run over the grown collection.
"""
from __future__ import annotations

import argparse
import os
import shutil
import threading
import time

import numpy as np

from repro_torch.configs import get_graph_config
from repro_torch.core.generator import generate_collection
from repro_torch.core.graph import TimeSeriesGraph
from repro_torch.gofs import GoFSStore, append_instances, deploy_collection
from repro_torch.gopher import GopherService, GopherSession
from repro_torch.launch.run_graph import default_deploy

WAIT_S = 600.0  # the longest wait on the service, the feeder or an update


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", default="small")
    p.add_argument("--deploy", default=default_deploy("gofs_tail"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--prefix", type=int, default=None,
                   help="instances deployed before serving starts "
                        "(default: half the collection)")
    p.add_argument("--batch", type=int, default=1,
                   help="instances per streamed append")
    p.add_argument("--interval", type=float, default=0.1,
                   help="seconds between appends")
    p.add_argument("--analytic", default="sssp",
                   choices=["sssp", "pagerank"])
    p.add_argument("--source", type=int, default=0,
                   help="seed vertex (sssp)")
    p.add_argument("--cache-slots", type=int, default=14)
    p.add_argument("--fresh", action="store_true",
                   help="wipe an existing deployment at --deploy")
    args = p.parse_args(argv)

    cfg = get_graph_config(args.size)
    tsg = generate_collection(cfg)
    n_total = len(tsg)
    prefix = args.prefix if args.prefix is not None else max(1, n_total // 2)
    assert 0 < prefix <= n_total, (prefix, n_total)

    manifest = os.path.join(args.deploy, "collection.json")
    if os.path.exists(manifest):
        if not args.fresh:
            raise SystemExit(
                f"{args.deploy} already holds a collection; pass --fresh "
                f"to wipe it")
        shutil.rmtree(args.deploy)
    print(f"[tail] deploying {prefix}/{n_total} instances of {cfg.name} "
          f"to {args.deploy} ...")
    deploy_collection(
        TimeSeriesGraph(template=tsg.template,
                        instances=tsg.instances[:prefix]),
        cfg, args.deploy)
    store = GoFSStore(args.deploy, cache_slots=args.cache_slots)

    params = {"source": args.source} if args.analytic == "sssp" else {}
    t0 = time.perf_counter()
    updates = []
    feed_errors = []

    def on_update(u):
        updates.append((time.perf_counter() - t0, u))
        print(f"[tail] +{updates[-1][0]:6.2f}s  {u.mode:<11} "
              f"n={u.result.engine.values.shape[-2]}  "
              f"new={u.new_instances}  version={u.version}")

    def feeder():
        try:
            for k in range(prefix, n_total, args.batch):
                time.sleep(args.interval)
                chunk = tsg.instances[k:k + args.batch]
                append_instances(
                    TimeSeriesGraph(template=tsg.template, instances=chunk),
                    args.deploy)
                print(f"[tail] appended instances "
                      f"[{k}, {k + len(chunk)}) to the deployment")
        except BaseException as e:  # re-raised on the main thread
            feed_errors.append(e)

    with GopherService(store, block_size=cfg.block_size, device=args.device,
                       poll_interval=min(0.05, args.interval / 2)) as svc:
        sub = svc.subscribe(args.analytic, callback=on_update, **params)
        sub.wait_update(1, timeout=WAIT_S)  # the initial full run
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        th.join(WAIT_S)
        if th.is_alive():
            raise TimeoutError(f"the feeder did not finish in {WAIT_S}s")
        if feed_errors:
            raise feed_errors[0]
        # boundary refreshes may coalesce appends into one update — wait
        # until the subscription covers the fully-grown collection
        deadline = time.perf_counter() + WAIT_S
        while time.perf_counter() < deadline:
            if sub.error is not None:
                raise sub.error
            u = sub.last
            if u is not None and int(
                    np.asarray(u.result.engine.values).shape[-2]) == n_total:
                break
            time.sleep(0.05)
        else:
            raise SystemExit(
                f"subscriber never caught up to {n_total} instances")
        rep = svc.report()
        sub.cancel()

    last = updates[-1][1]
    cold = GopherSession(GoFSStore(args.deploy, cache_slots=args.cache_slots),
                         block_size=cfg.block_size, device=args.device)
    ref = cold.run(cold.plan(args.analytic, **params))
    exact = all(
        np.array_equal(np.asarray(last.result.output[k]), np.asarray(v))
        for k, v in ref.output.items())
    print(f"[tail] {len(updates)} updates "
          f"({sum(1 for _, u in updates if u.mode == 'incremental')} "
          f"incremental), {rep['appends_observed']} appends observed, "
          f"final version {last.version}")
    print(f"[tail] tail result vs cold full re-run: "
          f"{'bitwise identical' if exact else 'MISMATCH'}")
    if not exact:
        raise SystemExit(1)
    return {"updates": [u for _, u in updates], "report": rep}


if __name__ == "__main__":
    main()
