"""Quickstart: the GoFFish pipeline end to end on the port (counterpart
of ``examples/quickstart.py``).

1. Generate a synthetic time-series graph collection (TR-like, paper §VI-A).
2. Deploy it to GoFS with temporal packing + subgraph binning (paper §V).
3. Run temporal SSSP through the iBSP engine ON the GoFS store (Gopher).
4. The declarative session API: ``GopherSession.plan`` auto-selects
   layout/comm/staging/kernel from the deployment's recorded metadata and
   the device, ``explain()`` shows the decisions + cost estimates,
   ``run()`` executes.
5. The explicit engine, for contrast: the same analytic hand-assembled
   from ``GoFSStore.load_blocked`` + ``TemporalEngine`` — what the
   session automates (and must match bitwise).
6. Shared staging: ``run_many`` executes three analytics staging each
   distinct batch once (SSSP and N-hop share the latency tiles).

  PYTHONPATH=src python -m repro_torch.examples.quickstart   # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.quickstart --comm host
  PYTHONPATH=src python -m repro_torch.examples.quickstart --layout sparse

``--comm`` / ``--layout`` override the corresponding planned knobs
(identical results either way — the plan records them as overrides).
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.core.algorithms import sssp
from repro_torch.core.generator import generate_collection
from repro_torch.gofs import GoFSStore, deploy_collection
from repro_torch.gopher import GopherSession


def main(comm=None, layout=None, device="cuda") -> None:
    cfg = GraphConfig(
        name="quickstart", num_vertices=2_000, avg_degree=3.0,
        num_instances=6, num_partitions=4, block_size=64,
        instances_per_slice=3, bins_per_partition=4, cache_slots=14, seed=1,
    )
    print("== 1. generate collection")
    tsg = generate_collection(cfg)
    tmpl = tsg.template
    print(f"   V={tmpl.num_vertices} E={tmpl.num_edges} "
          f"instances={len(tsg)} (2h windows)")

    with tempfile.TemporaryDirectory() as root:
        print("== 2. deploy to GoFS", root)
        # record nonzero-tile maps for latency: the session's planner
        # prices the sparse layout from these maps without a value read
        meta = deploy_collection(tsg, cfg, root,
                                 sparse_absent={"latency": np.inf})
        print(f"   partitions={meta['num_partitions']} "
              f"instances/slice={meta['instances_per_slice']} "
              f"bins/partition={meta['bins_per_partition']}")

        print("== 3. Gopher iBSP SSSP on GoFS (sequentially dependent)")
        store = GoFSStore(root, cache_slots=14, vertex_projection=(),
                          edge_projection=("latency", "active"))
        dists, res = sssp.run_host(store, source_vertex=0)
        d_host = np.full(tmpl.num_vertices, np.inf)
        for g, d in dists.items():
            d_host[store.get_topology(g).vertices] = d
        print(f"   reached {int(np.isfinite(d_host).sum())} vertices in "
              f"{res.stats.supersteps} supersteps, "
              f"{res.stats.superstep_messages} messages; "
              f"GoFS read {store.stats.slices_read} slices "
              f"({store.cache.stats()['hit_rate']:.0%} cache hits)")

        print("== 4. declarative session API: plan -> explain -> run")
        sess = GopherSession(store, device=device)
        plan = sess.plan("sssp", source=0, comm=comm, layout=layout)
        print("\n".join("   " + ln for ln in plan.explain().splitlines()))
        r_sssp = sess.run(plan)
        d_blk = r_sssp.output["final"]
        finite = np.isfinite(d_host)
        assert np.array_equal(np.isfinite(d_blk), finite)
        err = float(np.abs(d_blk[finite] - d_host[finite]).max())
        print(f"   max |session - host| = {err:.2e}  ✓ engines agree")

        print("== 5. the explicit engine, for contrast (what plan() automates)")
        from repro_torch.core.blocked import build_blocked
        from repro_torch.core.engine import (
            TemporalEngine, min_plus_program, source_init,
        )
        from repro_torch.core.partition import edge_cut, partition_graph

        assign = partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
        print(f"   edge cut: {edge_cut(tmpl, assign)}/{tmpl.num_edges}")
        bg = build_blocked(tmpl, assign, cfg.block_size)
        eng = TemporalEngine(bg, device=device, comm=plan.comm.value,
                             layout=plan.layout.value,
                             use_pallas=plan.kernel.value)
        if plan.layout.value == "sparse":
            sp = store.load_blocked(bg, "latency", layout="sparse")
            seq = eng.run(min_plus_program("sssp", init=source_init(0)),
                          sparse=sp, pattern="sequential")
            print(f"   block-sparse staging: tile occupancy "
                  f"{seq.occupancy:.1%}, staged bytes {sp.staged_bytes():,}")
        else:
            tiles, btiles = store.load_blocked(bg, "latency")
            seq = eng.run(min_plus_program("sssp", init=source_init(0)),
                          tiles=tiles, btiles=btiles, pattern="sequential")
        assert np.array_equal(seq.values, r_sssp.engine.values)
        print("   explicit engine == session bitwise  ✓ the session adds "
              "decisions, not semantics")
        print(f"   sequential SSSP stats: {seq.bsp_stats()}")

        print("== 6. shared staging: three analytics, one pass per batch")
        plans = [
            sess.plan("sssp", source=0, comm=comm, layout=layout),
            sess.plan("nhop", source=0, n_hops=4, comm=comm, layout=layout),
            sess.plan("pagerank", iters=10, comm=comm),
        ]
        many = sess.run_many(plans)
        rep = sess.last_run_report
        print(f"   {len(plans)} analytics "
              f"({', '.join(rep['analytics'])}) staged in "
              f"{rep['staging_passes']} passes, "
              f"{rep['staged_bytes']:,} staged bytes")
        assert np.array_equal(many[0].engine.values, r_sssp.engine.values)
        top = int(many[2].output["ranks"][0].argmax())
        print(f"   sssp identical to the solo run  ✓ sharing is invisible; "
              f"PageRank top vertex (t=0): {top}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--comm", choices=("dense", "ring", "host"),
                    default=None,
                    help="override the planned boundary-exchange backend "
                         "(repro_torch.core.comm; default: planner-selected)")
    ap.add_argument("--layout", choices=("dense", "sparse"),
                    default=None,
                    help="override the planned tile layout "
                         "(repro_torch.core.blocked.SparseBlocked)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    main(comm=args.comm, layout=args.layout, device=args.device)
