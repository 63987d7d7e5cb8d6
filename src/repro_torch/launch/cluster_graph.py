"""Multi-process Gopher launcher: N local workers over one GoFS deployment
(counterpart of ``repro.launch.cluster_graph``).

The paper's deployment shape (§V) — every worker computes on the shard it
hosts — as a runnable entrypoint:

  PYTHONPATH=src python -m repro_torch.launch.cluster_graph \\
      --num-processes 2 --apps sssp,pagerank --size small --check
  PYTHONPATH=src python -m repro_torch.launch.cluster_graph \\
      --num-processes 2 --apps sssp,pagerank --size tiny --device cpu --check

The parent deploys the collection (once), picks a free coordinator port,
and spawns ``--num-processes`` workers of THIS module (``--worker``).
Each worker boots its :class:`~repro_torch.cluster.runtime
.ClusterRuntime`, opens a :class:`~repro_torch.gopher.session
.GopherSession` bound to it on ``--device`` — so staging is shard-local
and the boundary exchange is the real inter-process gather — runs every
requested app, and writes its results (values, finals, superstep
counts, per-host staged bytes) to an ``.npz`` in ``--out``.  The workers
take the parent's ``--device`` (``cuda`` by default): several workers
share one card, each with its own CUDA context.

``--check`` makes the parent ALSO run the identical apps in a plain
single-process session and assert the cluster acceptance:

* every worker's values/finals/superstep counts are **bitwise
  identical** to the single-process run (and to each other);
* every worker's staged bytes are **strictly less** than the
  single-process staging cost (shard-local staging is real).

Exit status is non-zero on any violation.  ``--deploy`` and ``--out``
default to directories under the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

APP_PARAMS: Dict[str, dict] = {
    "sssp": {"source": 0},            # sequential pattern
    "pagerank": {"iters": 10},        # independent pattern
    "components": {},                 # independent, symmetrized graph
}

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_apps(sess, apps: List[str]) -> Dict[str, Dict[str, np.ndarray]]:
    """Run each app through the session, recording result arrays and the
    staging economy of its pass."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for app in apps:
        plan = sess.plan(app, staging="async", **APP_PARAMS[app])
        res = sess.run_many([plan])[0]
        eng = res.engine
        out[app] = {
            "values": np.asarray(eng.values),
            "final": np.asarray(eng.final),
            "supersteps": np.asarray(eng.stats["supersteps"]),
            "staged_bytes": np.asarray(
                int(sess.last_run_report["staged_bytes"])),
        }
    return out


def open_session(args, runtime=None, **session_kw):
    """(cfg, session) over ``args.deploy`` on ``args.device``, one shard
    of ``runtime``'s run when it is distributed."""
    from repro_torch.gopher import GopherSession
    from repro_torch.launch.run_graph import ensure_deployment

    cfg, store = ensure_deployment(args.size, args.deploy, args.cache_slots)
    return cfg, GopherSession(store, block_size=cfg.block_size,
                              device=args.device, cluster=runtime,
                              **session_kw)


def worker_results_path(out: str, process_id: int) -> str:
    return os.path.join(out, f"worker_{process_id}.npz")


def worker_run(args, runtime) -> Dict[str, Dict[str, np.ndarray]]:
    """One worker's apps on its shard; writes and returns the results."""
    _cfg, sess = open_session(args, runtime)
    results = run_apps(sess, args.apps.split(","))
    flat = {f"{app}/{k}": v for app, r in results.items()
            for k, v in r.items()}
    os.makedirs(args.out, exist_ok=True)
    np.savez(worker_results_path(args.out, runtime.process_id), **flat)
    return results


def worker_main(args) -> None:
    from repro_torch.cluster.runtime import init_cluster

    rt = init_cluster(transport=args.transport)  # GOFFISH_* env from parent
    try:
        worker_run(args, rt)
        rt.barrier("done")
    finally:
        rt.close()


def worker_env(coordinator: str, num_processes: int, process_id: int,
               transport: str) -> Dict[str, str]:
    """The environment of one spawned worker (``init_cluster`` reads it)."""
    from repro_torch.cluster import runtime as cr

    return dict(os.environ, **{
        cr.ENV_COORDINATOR: coordinator,
        cr.ENV_NUM_PROCESSES: str(num_processes),
        cr.ENV_PROCESS_ID: str(process_id),
        cr.ENV_TRANSPORT: transport,
    })


def launch_workers(args, coordinator: str) -> List[subprocess.Popen]:
    procs = []
    for pid in range(args.num_processes):
        cmd = [
            sys.executable, "-m", "repro_torch.launch.cluster_graph",
            "--worker",
            "--apps", args.apps, "--size", args.size,
            "--deploy", args.deploy, "--out", args.out,
            "--transport", args.transport, "--device", args.device,
            "--cache-slots", str(args.cache_slots),
        ]
        procs.append(subprocess.Popen(
            cmd, env=worker_env(coordinator, args.num_processes, pid,
                                args.transport),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_workers(procs: List[subprocess.Popen], timeout: float) -> None:
    """Wait for every worker (one deadline for all).  A worker that times
    out or fails kills the others and exits with its output."""
    deadline = time.monotonic() + timeout
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise SystemExit(f"worker {i} timed out")
        if p.returncode != 0:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            sys.stderr.write(out or "")
            raise SystemExit(f"worker {i} exited with {p.returncode}")


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (-0 is not +0; NaN equals NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def check_parity(args) -> Dict[str, dict]:
    """Single-process reference run + the acceptance assertions over the
    workers' ``.npz`` files."""
    apps = args.apps.split(",")
    _cfg, sess = open_session(args)
    ref = run_apps(sess, apps)

    workers = []
    for pid in range(args.num_processes):
        path = worker_results_path(args.out, pid)
        assert os.path.exists(path), f"worker {pid} left no results"
        workers.append(np.load(path))

    report: Dict[str, dict] = {}
    for app in apps:
        single = int(ref[app]["staged_bytes"])
        per_host = []
        for pid, w in enumerate(workers):
            for key in ("values", "final", "supersteps"):
                got, want = w[f"{app}/{key}"], ref[app][key]
                assert same_bits(got, want), \
                    f"{app}: worker {pid} {key} diverges from the " \
                    f"single-process run"
            per_host.append(int(w[f"{app}/staged_bytes"]))
        # components stages its symmetrized variant through the
        # materialized path (full-width, engine-sliced); only streamed
        # template apps must show the per-host byte saving
        if single > 0 and app != "components":
            for pid, b in enumerate(per_host):
                assert b < single, \
                    f"{app}: worker {pid} staged {b} bytes, single-process " \
                    f"staged {single} — shard staging saved nothing"
        report[app] = {"single_staged_bytes": single,
                       "per_host_staged_bytes": per_host}
    return report


def default_dir(name: str) -> str:
    """A directory under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="internal: run as one spawned worker process")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--apps", default="sssp,pagerank",
                    help=f"comma list from {sorted(APP_PARAMS)}")
    ap.add_argument("--size", default="tiny",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--deploy", default=default_dir("gofs_cluster"))
    ap.add_argument("--out", default=default_dir("gofs_cluster_out"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every worker computes (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--transport", default="tcp",
                    choices=["tcp", "torch", "auto"],
                    help="tcp: host-lane exchange only; torch: also join "
                         "torch.distributed (gloo)")
    ap.add_argument("--cache-slots", type=int, default=14)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--check", action="store_true",
                    help="run the single-process reference and assert "
                         "bitwise parity + per-host staged-byte savings")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    for app in args.apps.split(","):
        assert app in APP_PARAMS, f"unknown app {app!r}"

    if args.worker:
        worker_main(args)
        return

    from repro_torch.launch.run_graph import ensure_deployment

    ensure_deployment(args.size, args.deploy, args.cache_slots)  # once
    coordinator = f"127.0.0.1:{free_port()}"
    t0 = time.time()
    procs = launch_workers(args, coordinator)
    wait_workers(procs, args.timeout)
    print(f"[cluster] {args.num_processes} workers x {args.apps} on "
          f"{args.device} done in {time.time() - t0:.1f}s")
    if args.check:
        report = check_parity(args)
        print(f"[cluster] parity OK: {json.dumps(report)}")


if __name__ == "__main__":
    main()
