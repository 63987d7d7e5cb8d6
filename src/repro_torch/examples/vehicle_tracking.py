"""Vehicle tracking — the paper's Algorithm 1, end to end, on the port
(counterpart of ``examples/vehicle_tracking.py``).

A camera network sees license plates per 2h window; the sequentially
dependent iBSP traces a target vehicle across space (DFS within subgraphs,
messages across) and time (SendToNextTimeStep carries the last sighting).
The host engine's trace must equal the blocked engine's, through the
session API.

  PYTHONPATH=src python -m repro_torch.examples.vehicle_tracking  # the card
  PYTHONPATH=src python -m repro_torch.examples.vehicle_tracking --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.core.algorithms import tracking
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.ibsp import InMemoryProvider
from repro_torch.core.partition import discover_subgraphs, partition_graph
from repro_torch.core.subgraph import build_subgraphs


def main(device="cuda") -> None:
    cfg = GraphConfig(
        name="cameras", num_vertices=1_500, avg_degree=3.0,
        num_instances=10, num_partitions=4, block_size=64, seed=9,
    )
    tsg = generate_collection(cfg, num_plates=12)
    tmpl = tsg.template
    plates = np.stack([tsg.vertex_values(t, "plate") for t in range(len(tsg))])

    target = 7
    first_seen = np.nonzero(plates[0] == target)[0]
    start = int(first_seen[0]) if len(first_seen) else 0
    print(f"tracking plate {target} from camera {start}")

    # faithful host engine (Alg. 1: DFS + remote handoff + timestep handoff)
    assign = partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
    sg_ids = discover_subgraphs(tmpl, assign)
    subs = build_subgraphs(tmpl, assign, sg_ids)
    prov = InMemoryProvider(tsg, subs, vertex_attrs=("plate",),
                            edge_attrs=("latency",))
    trace_host, res = tracking.run_host(prov, target, start, search_depth=6)
    print("host trace   :", trace_host)
    print(f"  ({res.stats.supersteps} supersteps, "
          f"{res.stats.superstep_messages} cross-subgraph messages)")

    # blocked engine (masked min-plus wavefront) via the session API
    from repro_torch.gopher import GopherSession

    bg = build_blocked(tmpl, assign, cfg.block_size)
    sess = GopherSession.from_blocked(bg, vertex_attrs={"plate": plates},
                                      device=device)
    trace_blk = sess.run(sess.plan(
        "tracking", plate=target, initial_vertex=start, search_depth=6,
    )).output["trace"]
    print("blocked trace:", trace_blk)
    assert trace_host == trace_blk, "engines must produce the same trace"
    print(f"✓ traced through {len(trace_host)} of {len(tsg)} windows; "
          "engines agree")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
