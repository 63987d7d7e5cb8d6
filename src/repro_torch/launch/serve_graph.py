"""Analytic serving CLI: a warm GopherService over a GoFS deployment
(counterpart of ``repro.launch.serve_graph``).

  PYTHONPATH=src python -m repro_torch.launch.serve_graph --size small \
      --queries 16 --clients 4                         # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --size tiny \
      --queries 12 --clients 4 --device cpu

Deploys (or reuses) a collection, starts one :class:`~repro_torch.gopher
.GopherService` on ``--device`` (``cuda`` by default), optionally
prestages the hot analytics, then fires a mixed query workload from
``--clients`` concurrent submitter threads — SSSP and N-hop requests
with random seed vertices, which the service coalesces on the source
axis into multi-source engine passes.  Prints per-request p50/p95
latency, throughput, batch shape, and the warm staging cache's economy
(bytes staged once, hit counts).
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.gopher import GopherService
from repro_torch.launch.run_graph import default_deploy, ensure_deployment

# every wait on the service is bounded: a failed batch raises in its
# waiter, a hung one fails the run
WAIT_S = 600.0


def build_workload(rng, cfg, n_queries: int):
    """A mixed interactive workload: mostly SSSP point queries, some
    N-hop — all over the same two staged batches, seeds drawn at random
    (the shape source-axis batching is designed for)."""
    reqs = []
    for _ in range(n_queries):
        v = int(rng.integers(0, cfg.num_vertices))
        if rng.random() < 0.75:
            reqs.append(("sssp", {"source": v}))
        else:
            reqs.append(("nhop", {"source": v, "n_hops": 4}))
    return reqs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", default="small")
    p.add_argument("--deploy", default=default_deploy("gofs_serve"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache-slots", type=int, default=14)
    p.add_argument("--queries", type=int, default=16)
    p.add_argument("--clients", type=int, default=4,
                   help="concurrent submitter threads")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--cache-bytes", type=float, default=256 << 20,
                   help="session-lifetime staging cache budget")
    p.add_argument("--no-prestage", action="store_true",
                   help="skip warming the caches before timing")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    cfg, store = ensure_deployment(args.size, args.deploy, args.cache_slots)
    rng = np.random.default_rng(args.seed)
    reqs = build_workload(rng, cfg, args.queries)

    with GopherService(store, block_size=cfg.block_size,
                       device=args.device,
                       staging_cache_bytes=args.cache_bytes,
                       max_batch_queries=args.max_batch) as svc:
        if not args.no_prestage:
            t0 = time.perf_counter()
            svc.prestage("sssp", source=0)
            svc.prestage("nhop", source=0)
            # one throwaway query per analytic warms the engines
            svc.query_many([("sssp", {"source": 0}),
                            ("nhop", {"source": 0, "n_hops": 4})],
                           timeout=WAIT_S)
            print(f"[serve] prestage+warm-up "
                  f"{time.perf_counter() - t0:.2f}s")

        chunks = np.array_split(np.arange(len(reqs)), max(1, args.clients))
        errors = []
        t0 = time.perf_counter()

        def client(idx):
            try:
                svc.query_many([reqs[i] for i in idx], timeout=WAIT_S)
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in chunks if len(c)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"a client did not finish within {WAIT_S}s")
        if errors:
            raise errors[0]

        rep = svc.report()
        print(f"[serve] {args.queries} queries from {args.clients} "
              f"clients in {wall:.2f}s "
              f"({args.queries / wall:.1f} q/s wall)")
        print(f"[serve] p50 {rep['p50_ms']:.1f} ms   "
              f"p95 {rep['p95_ms']:.1f} ms   "
              f"batches {rep['batches']} (widest {rep['widest_batch']})")
        sc = rep["staging_cache"]
        if sc:
            print(f"[serve] staging cache: {sc['entries']} resident "
                  f"batches, {sc['resident_bytes'] / 1e6:.1f} MB, "
                  f"{sc['hits']} hits / {sc['staging_passes']} passes")
    return rep


if __name__ == "__main__":
    main()
