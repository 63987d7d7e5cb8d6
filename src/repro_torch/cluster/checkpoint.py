"""Resumable long-running analytics: periodic engine-state snapshots
(counterpart of ``repro.cluster.checkpoint``).

A collection-scale analytic pass can outlive a worker lease.  This module
makes the pass restartable without changing its result: the instance axis
is consumed in fixed spans, and after every ``every`` spans the run's
engine state — the pattern carry (converged state seeding the next span),
the accumulated per-instance values, the superstep counters, and the
staging cursor — is snapshotted through the atomic-rename/retention
helpers of :mod:`repro_torch.train.checkpoint`:

* a crash mid-save never corrupts the previous snapshot (tmp dir + fsync
  + rename; ``list_steps`` skips uncommitted dirs);
* retention keeps the newest K snapshots;
* a resumed run re-executes only the spans past the cursor, seeded from
  the snapshotted carry — and because chunking a pattern scan is exact
  (each instance sees the identical seed and staged tiles), the resumed
  result is **bitwise identical** to the uninterrupted run.

Snapshots carry a *run fingerprint* (analytic, params, pattern, span
size, collection length, process count).  Resuming against a snapshot
from a different run raises :class:`ResumeMismatch` instead of silently
blending state.  Snapshot files, manifest and fingerprint are the
reference's, so each package resumes the other's runs.

Multi-process runs snapshot from process 0 only: engine results are
already gathered on every process (identical bytes), and the fingerprint
pins the process count so a resumed run re-shards the same way.
``GopherSession.run(plan, checkpoint_dir=..., resume=True)`` is the
user-facing entry (:mod:`repro_torch.gopher.session`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.train import checkpoint as _ckpt


class ResumeMismatch(RuntimeError):
    """A resume attempted against a snapshot of a DIFFERENT run (analytic,
    params, pattern, chunking, or collection length changed)."""


class AnalyticCheckpointer:
    """Atomic snapshots of one analytic run's engine state.

    ``save`` commits the state dict under ``step_<cursor>`` with the run
    fingerprint in the manifest; ``latest`` loads the newest COMMITTED
    snapshot (torn tmp dirs are invisible) and verifies the fingerprint.

    >>> import numpy as np, tempfile
    >>> d = tempfile.mkdtemp()
    >>> ck = AnalyticCheckpointer(d)
    >>> fp = {"analytic": "sssp", "chunk": 2}
    >>> _ = ck.save(2, {"final": np.zeros(3, np.float32)}, fp)
    >>> state, cursor = ck.latest(fp)
    >>> cursor, state["final"].shape
    (2, (3,))
    >>> try:
    ...     ck.latest({"analytic": "pagerank", "chunk": 2})
    ... except ResumeMismatch:
    ...     print("different run refused")
    different run refused
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep

    def save(self, cursor: int, state: Dict[str, np.ndarray],
             fingerprint: Dict[str, Any]) -> str:
        """Atomically commit ``state`` at staging cursor ``cursor``."""
        return _ckpt.save(
            self.ckpt_dir, cursor, state, keep=self.keep,
            extra_meta={"fingerprint": _canon(fingerprint)},
        )

    def latest(
        self, fingerprint: Optional[Dict[str, Any]] = None,
    ) -> Optional[Tuple[Dict[str, np.ndarray], int]]:
        """Newest committed ``(state, cursor)``; ``None`` when the
        directory holds no committed snapshot.  Raises
        :class:`ResumeMismatch` when the stored fingerprint differs from
        ``fingerprint`` — resuming a different run would blend state."""
        steps = _ckpt.list_steps(self.ckpt_dir)
        if not steps:
            return None
        d = os.path.join(self.ckpt_dir, f"step_{steps[-1]:08d}")
        with open(os.path.join(d, _ckpt.MANIFEST)) as f:
            manifest = json.load(f)
        if fingerprint is not None:
            got = manifest.get("extra", {}).get("fingerprint")
            want = _canon(fingerprint)
            if got != want:
                raise ResumeMismatch(
                    f"checkpoint in {self.ckpt_dir} belongs to a different "
                    f"run: {got!r} != {want!r}")
        state = {
            name: np.load(os.path.join(d, meta["file"]))
            for name, meta in manifest["leaves"].items()
        }
        return state, int(manifest["step"])


def _canon(fp: Dict[str, Any]) -> Dict[str, Any]:
    """JSON round-trip so saved and in-memory fingerprints compare equal
    (tuples become lists, ints stay ints)."""
    return json.loads(json.dumps(fp, sort_keys=True))


def run_fingerprint(plan, num_instances: int, chunk: int,
                    num_processes: int = 1) -> Dict[str, Any]:
    """What must match for a snapshot to seed this run."""
    from repro_torch.gopher.session import _freeze_value

    return {
        "analytic": plan.analytic,
        "params": repr(_freeze_value(plan.param_dict)),
        "pattern": plan.pattern,
        "merge": plan.merge,
        "warm": bool(plan.warm.value),
        "num_instances": int(num_instances),
        "chunk": int(chunk),
        "num_processes": int(num_processes),
    }


class ResumableRun:
    """One checkpointed analytic pass over a session's collection.

    Executes ``plan`` span by span through the session's engine (the
    spans chain exactly like the engine's own chunked scan, so the
    combined result is bitwise-identical to ``session.run(plan)``),
    snapshotting after every ``every`` spans and after the final one.
    ``run(resume=True)`` skips the spans a prior snapshot already
    covered.

    Patterns: ``sequential`` (the carry IS the pattern), ``independent``
    (cold spans are trivially exact; warm plans chain the seed across
    spans under the same monotone contract as ``RunSpec.warm_start``),
    and ``eventually`` without an on-device merge.  Composite analytics
    and ``merge="mean"`` plans have no single resumable engine pass.
    The combined result's stats hold ``supersteps`` and
    ``local_sweeps`` (what a snapshot carries).
    """

    def __init__(self, session, plan, *, checkpoint_dir: str,
                 every: int = 1, keep: int = 3,
                 chunk_instances: Optional[int] = None):
        from repro_torch.gopher.registry import get_analytic

        self.session = session
        self.plan = plan
        self.analytic = get_analytic(plan.analytic)
        assert not self.analytic.composite, \
            f"{plan.analytic!r} is composite: no single engine pass to " \
            f"checkpoint"
        assert plan.pattern in ("sequential", "independent") or (
            plan.pattern == "eventually" and plan.merge is None), \
            f"pattern {plan.pattern!r}/merge {plan.merge!r} has no exact " \
            f"span decomposition"
        self.every = max(1, int(every))
        self.checkpointer = AnalyticCheckpointer(checkpoint_dir, keep=keep)
        w = session._staged_weights(self.analytic)
        self.weights = w if w.ndim > 1 else w[None]
        I = self.weights.shape[0]
        self.chunk = int(chunk_instances or max(1, -(-I // 4)))
        self.spans = [(s, min(s + self.chunk, I))
                      for s in range(0, I, self.chunk)]
        rt = getattr(session, "cluster", None)
        self.runtime = rt if (rt is not None and rt.is_distributed) else None
        self.fingerprint = run_fingerprint(
            plan, I, self.chunk,
            self.runtime.num_processes if self.runtime else 1)

    def run(self, resume: bool = False):
        """Execute (or finish) the pass; returns the session-level
        :class:`~repro_torch.gopher.session.AnalyticResult` over the FULL
        collection."""
        from repro_torch.core.engine import EngineResult, RunSpec
        from repro_torch.gopher.session import PlanContext, _StagingCache

        sess, plan, a = self.session, self.plan, self.analytic
        cache = sess._staging_cache if sess._staging_cache is not None \
            else _StagingCache()
        ctx = PlanContext(sess, plan, a, cache)
        program = a.make_program(ctx, **plan.param_dict)
        engine = sess._engine(plan.graph, plan.comm.value,
                              plan.kernel.value)
        warm = bool(plan.warm.value) and program.kind == "fixpoint"
        zero = float(a.zero_fill)

        cursor = 0
        vals, sss, lsws = [], [], []
        carry: Optional[np.ndarray] = None  # gathered (V,) / (Q, V) final
        if resume:
            got = self.checkpointer.latest(self.fingerprint)
            if got is not None:
                state, cursor = got
                carry = state["final"]
                vals, sss = [state["values"]], [state["supersteps"]]
                lsws = [state["local_sweeps"]]

        done = sum(1 for _, e in self.spans if e <= cursor)
        for s, e in self.spans:
            if e <= cursor:
                continue
            assert s >= cursor, \
                f"snapshot cursor {cursor} misaligned with span ({s}, {e})"
            chained = plan.pattern == "sequential" or warm
            if carry is not None and chained:
                spec = RunSpec(program, plan.pattern,
                               x0=engine.resume_seed(carry, pad=zero),
                               warm_start=warm)
            else:
                spec = RunSpec(program, plan.pattern, warm_start=warm)
            res = engine.run_many([spec], self.weights[s:e],
                                  staging="sync")[0]
            carry = np.asarray(res.final)
            vals.append(np.asarray(res.values))
            sss.append(np.asarray(res.stats["supersteps"]))
            lsws.append(np.asarray(res.stats["local_sweeps"]))
            cursor = e
            done += 1
            if done % self.every == 0 or cursor == self.spans[-1][1]:
                self._snapshot(cursor, carry, vals, sss, lsws)

        assert carry is not None, "empty collection"
        bg = engine.bg
        combined = EngineResult(
            pattern=plan.pattern,
            values=_cat(vals, axis=-2),
            final=carry,
            merged=None,
            stats={"supersteps": _cat(sss, axis=-1),
                   "local_sweeps": _cat(lsws, axis=-1)},
            occupancy=None,
            warm_start=warm,
            n_sources=carry.shape[0] if carry.ndim == 2 else None,
            _n_published=int(bg.n_out.sum()),
            _n_parts=bg.n_parts,
            _num_vertices=len(bg.part_of),
        )
        return sess._wrap(plan, a, combined, cache)

    def _snapshot(self, cursor, carry, vals, sss, lsws) -> None:
        """Commit the run state at ``cursor``.  Every process holds the
        identical gathered state, so process 0 writes for everyone; the
        barrier keeps a fast peer from racing ahead and snapshotting a
        LATER cursor into the same directory out of order."""
        if self.runtime is None or self.runtime.process_id == 0:
            self.checkpointer.save(cursor, {
                "final": np.asarray(carry),
                "values": _cat(vals, axis=-2),
                "supersteps": _cat(sss, axis=-1),
                "local_sweeps": _cat(lsws, axis=-1),
            }, self.fingerprint)
        if self.runtime is not None:
            self.runtime.barrier(f"ckpt/{cursor}")


def _cat(parts, axis: int) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)
