"""Temporal SSSP under changing traffic (paper §I's motivating example),
on the port (counterpart of ``examples/temporal_sssp.py``).

A road-grid template with diurnal edge latencies: the shortest path from a
depot evolves across 2-hour instances; the sequentially dependent iBSP
carries distances between timesteps (a vertex only improves as new
conditions are observed — incremental aggregation, §VI-A).

The analytic is declared through the Gopher session API: the session
partitions + blocks the in-memory collection, ``plan()`` resolves every
execution knob (with ``--comm``/``--layout`` as overrides), and one
``run()`` executes the whole sequential pattern.  An explicit
``TemporalEngine`` block follows for contrast — the session must match it
bitwise, and so must async staging in chunks of 3 instances.

  PYTHONPATH=src python -m repro_torch.examples.temporal_sssp  # the card
  PYTHONPATH=src python -m repro_torch.examples.temporal_sssp --device cpu
  PYTHONPATH=src python -m repro_torch.examples.temporal_sssp --comm ring
  PYTHONPATH=src python -m repro_torch.examples.temporal_sssp --layout sparse
"""
import argparse

import numpy as np

from repro_torch.core.graph import (
    AttributeDef, GraphInstance, GraphTemplate, TimeSeriesGraph,
)
from repro_torch.gopher import GopherSession


def road_grid(n: int) -> GraphTemplate:
    ids = np.arange(n * n).reshape(n, n)
    src = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel(),
                          ids[:, 1:].ravel(), ids[1:, :].ravel()])
    dst = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel(),
                          ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    return GraphTemplate(
        num_vertices=n * n, src=src.astype(np.int64), dst=dst.astype(np.int64),
        edge_attrs=(AttributeDef("travel_time", "float32", default=1.0),),
    )


def main(comm=None, layout=None, device="cuda") -> None:
    n = 32
    tmpl = road_grid(n)
    rng = np.random.default_rng(0)
    instances = []
    for t in range(12):  # one day, 2h windows
        rush = 1.0 + 2.5 * np.exp(-((t - 4) ** 2) / 2) + 2.5 * np.exp(
            -((t - 9) ** 2) / 2)  # two rush hours
        w = (rng.gamma(3.0, 0.4, tmpl.num_edges) * rush).astype(np.float32)
        instances.append(GraphInstance(
            timestamp=t * 7200.0, duration=7200.0,
            edge_values={"travel_time": w},
        ))
    tsg = TimeSeriesGraph(tmpl, instances)

    depot = 0
    # "sssp" is registered over the "latency" attribute; this template
    # calls it "travel_time", so register a tiny alias analytic — the
    # declarative API is extensible, not a closed enum.
    from repro_torch.gopher import REQUIRED, list_analytics, register_analytic

    if "grid_sssp" not in list_analytics():
        @register_analytic(
            "grid_sssp", pattern="sequential", attr="travel_time",
            zero_fill=np.inf, params={"source": REQUIRED},
            postprocess=lambda ctx, res, **_: {"final": res.final},
            describe="temporal SSSP over travel_time",
        )
        def _grid_sssp(ctx, *, source):
            from repro_torch.core.engine import min_plus_program, source_init

            return min_plus_program("sssp", init=source_init(source))

    sess = GopherSession(tsg, num_partitions=4, block_size=64, device=device)
    plan = sess.plan("grid_sssp", source=depot, comm=comm, layout=layout)
    print(plan.explain())
    res_a = sess.run(plan)
    res = res_a.engine
    if plan.layout.value == "sparse":
        print(f"✓ block-sparse staging: measured tile occupancy "
              f"{res.occupancy:.1%}")
    print("t  reachable<40min  mean_dist  supersteps")
    for t in range(len(tsg)):
        d_t = res.values[t]
        finite = np.isfinite(d_t)
        print(f"{t:2d}  {int((d_t[finite] < 40).sum()):6d}        "
              f"{d_t[finite].mean():8.2f}   {res.stats['supersteps'][t]}")
    dist = res.final
    # distances only improve over time (incremental aggregation invariant)
    d_first = res.values[0]
    fin = np.isfinite(d_first)
    assert np.all(dist[fin] <= d_first[fin] + 1e-5)
    print("✓ incremental aggregation: final distances <= first-instance distances")

    # Explicit-engine contrast: hand-assemble what plan() chose — the
    # session adds decisions, not semantics, so values match bitwise.
    from repro_torch.core.blocked import build_blocked
    from repro_torch.core.engine import (TemporalEngine, min_plus_program,
                                         source_init)
    from repro_torch.core.partition import partition_graph

    assign = partition_graph(tmpl, 4, seed=0)
    bg = build_blocked(tmpl, assign, 64)
    w = np.stack([tsg.edge_values(t, "travel_time") for t in range(len(tsg))])
    knobs = dict(device=device, comm=plan.comm.value,
                 layout=plan.layout.value, use_pallas=plan.kernel.value)
    eng = TemporalEngine(bg, **knobs)
    res_eng = eng.run(min_plus_program("sssp", init=source_init(depot)), w,
                      pattern="sequential")
    assert np.array_equal(res.values, res_eng.values)
    print(f"✓ session (comm={plan.comm.value}, layout={plan.layout.value}) "
          f"== explicit engine bitwise on every timestep")
    # async staging: instance k+1's tiles fill while instance k executes;
    # the sequential carry crosses chunk boundaries bitwise-identically
    eng_async = TemporalEngine(bg, staging="async", chunk_instances=3,
                               **knobs)
    res_async = eng_async.run(
        min_plus_program("sssp", init=source_init(depot)), w,
        pattern="sequential")
    assert np.array_equal(res_async.values, res.values)
    print("✓ double-buffered staging: identical distances, overlapped fills")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--comm", choices=("dense", "ring", "host"),
                    default=None,
                    help="override the planned boundary-exchange backend "
                         "(repro_torch.core.comm)")
    ap.add_argument("--layout", choices=("dense", "sparse"),
                    default=None,
                    help="override the planned tile layout")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    main(comm=args.comm, layout=args.layout, device=args.device)
