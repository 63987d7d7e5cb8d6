"""Resumable analytics on the port (``tests/test_cluster_checkpoint.py``'s
cases, on the port), and snapshots shared with the JAX package.

* The checkpointer's round trip, fingerprint refusal and retention; torn
  ``.tmp`` and manifest-less directories are invisible.
* Checkpointed SSSP and PageRank bitwise equal to uninterrupted runs,
  and resumed from the first snapshot; a resume of another run is
  refused, and ``resume=True`` without a directory too.
* A run killed in a child process mid-save and mid-superstep resumes
  bitwise equal to the uninterrupted run.
* Across packages: a snapshot the reference wrote is resumed by the port
  (and the reverse), finishing bitwise equal to the reference's
  uninterrupted run; the two fingerprints and manifests are equal.
* A two-process resumable run, written by process 0 only.

Every wait takes a timeout.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.cluster.checkpoint import run_fingerprint as j_run_fingerprint
from repro.gofs import GoFSStore as JGoFSStore
from repro.gofs import deploy_collection as j_deploy
from repro.gopher import GopherSession as JGopherSession
from repro.train import checkpoint as j_ckpt
from repro_torch.cluster import checkpoint as p_cc
from repro_torch.cluster.checkpoint import (AnalyticCheckpointer,
                                            ResumeMismatch, run_fingerprint)
from repro_torch.gofs import GoFSStore
from repro_torch.gopher import GopherSession
from repro_torch.train import checkpoint as _ckpt

from tests.conftest import TINY
from tests.test_torch_cluster import run_peers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 600  # seconds: the longest a child process is waited on


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ck_store_root(tiny_collection, tmp_path_factory):
    """TINY deployed by the reference (both packages' stores open it)."""
    root = str(tmp_path_factory.mktemp("gofs_ck"))
    j_deploy(tiny_collection, TINY, root)
    return root


def _session(root, **kw):
    return GopherSession(GoFSStore(root), device="cpu", **kw)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_run(got, want):
    for key in ("values", "final"):
        _bits(getattr(got.engine, key), getattr(want.engine, key), key)
    _bits(got.engine.stats["supersteps"], want.engine.stats["supersteps"])


# ----------------------------------------------------------- checkpointer

def test_checkpointer_roundtrip_and_fingerprint(tmp_path):
    ck = AnalyticCheckpointer(str(tmp_path), keep=2)
    fp = {"analytic": "sssp", "chunk": 2, "params": "(('source', 0),)"}
    assert ck.latest(fp) is None  # empty dir: fresh run
    ck.save(2, {"final": np.arange(3, dtype=np.float32)}, fp)
    ck.save(4, {"final": np.arange(3, dtype=np.float32) + 1}, fp)
    state, cursor = ck.latest(fp)
    assert cursor == 4
    _bits(state["final"], np.arange(3, dtype=np.float32) + 1)
    with pytest.raises(ResumeMismatch):
        ck.latest({"analytic": "pagerank", "chunk": 2})
    # retention: keep=2 drops the oldest after a third save
    ck.save(6, {"final": np.zeros(3, np.float32)}, fp)
    assert _ckpt.list_steps(str(tmp_path)) == [4, 6]
    assert j_ckpt.list_steps(str(tmp_path)) == [4, 6]


def test_torn_checkpoint_is_invisible(tmp_path):
    """A crash mid-write leaves a .tmp dir or a dir without a manifest —
    neither may ever be loaded."""
    ck = AnalyticCheckpointer(str(tmp_path))
    fp = {"analytic": "sssp"}
    ck.save(2, {"final": np.ones(3, np.float32)}, fp)
    os.makedirs(tmp_path / "step_00000004.tmp")
    np.save(tmp_path / "step_00000004.tmp" / "final.npy", np.zeros(3))
    os.makedirs(tmp_path / "step_00000006")  # renamed dir missing manifest
    assert _ckpt.list_steps(str(tmp_path)) == [2]
    state, cursor = ck.latest(fp)
    assert cursor == 2 and np.array_equal(state["final"], np.ones(3))


# ------------------------------------------------------------ run parity

@pytest.mark.parametrize("app,params", [
    ("sssp", {"source": 0}),          # sequential: carry IS the pattern
    ("pagerank", {"iters": 5}),       # independent: cold spans
])
def test_checkpointed_run_bitwise_and_resume(ck_store_root, tmp_path,
                                             app, params):
    sess = _session(ck_store_root)
    plan = sess.plan(app, **params)
    ref = sess.run(plan)
    d = str(tmp_path / app)
    got = sess.run(plan, checkpoint_dir=d, checkpoint_chunk=1)
    _same_run(got, ref)
    for k, v in ref.output.items():
        if isinstance(v, np.ndarray):
            _bits(got.output[k], v, k)
    # drop everything after the FIRST snapshot, then resume
    steps = _ckpt.list_steps(d)
    assert len(steps) >= 2
    for s in steps[1:]:
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    res = sess.run(plan, checkpoint_dir=d, checkpoint_chunk=1, resume=True)
    _same_run(res, ref)


def test_resume_refuses_different_run(ck_store_root, tmp_path):
    sess = _session(ck_store_root)
    d = str(tmp_path / "ck")
    sess.run(sess.plan("sssp", source=0), checkpoint_dir=d,
             checkpoint_chunk=1)
    with pytest.raises(ResumeMismatch):
        sess.run(sess.plan("sssp", source=1), checkpoint_dir=d,
                 checkpoint_chunk=1, resume=True)


def test_resume_needs_checkpoint_dir(ck_store_root):
    sess = _session(ck_store_root)
    with pytest.raises(AssertionError):
        sess.run(sess.plan("sssp", source=0), resume=True)


# -------------------------------------------------------- fault injection

CRASH_CHILD = textwrap.dedent("""\
    import os, sys
    mode, root, ckdir = sys.argv[1], sys.argv[2], sys.argv[3]

    from repro_torch.train import checkpoint as _ckpt

    if mode == "mid-save":
        # die INSIDE the second commit: tmp dir fully written, rename
        # never happens -> torn .tmp next to the intact first snapshot
        real_rename = os.rename
        calls = {"n": 0}

        def dying_rename(src, dst):
            if os.path.basename(dst).startswith("step_"):
                calls["n"] += 1
                if calls["n"] == 2:
                    os._exit(1)
            return real_rename(src, dst)

        _ckpt.os.rename = dying_rename
    elif mode == "mid-superstep":
        # die during the second span's compute: first snapshot committed,
        # nothing else written
        from repro_torch.core.engine import TemporalEngine

        real_run_many = TemporalEngine.run_many
        calls = {"n": 0}

        def dying_run_many(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                os._exit(1)
            return real_run_many(self, *a, **k)

        TemporalEngine.run_many = dying_run_many
    else:
        raise SystemExit(f"unknown mode {mode}")

    from repro_torch.gofs import GoFSStore
    from repro_torch.gopher import GopherSession

    sess = GopherSession(GoFSStore(root), device="cpu")
    sess.run(sess.plan("sssp", source=0), checkpoint_dir=ckdir,
             checkpoint_chunk=1, checkpoint_every=1)
    os._exit(0)  # should be unreachable: the crash fires first
""")


@pytest.mark.parametrize("mode", ["mid-save", "mid-superstep"])
def test_kill_and_resume_bitwise(ck_store_root, tmp_path, mode):
    child = tmp_path / "crash_child.py"
    child.write_text(CRASH_CHILD)
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(child), mode, ck_store_root, ckdir],
        env=env, capture_output=True, text=True, timeout=WAIT)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)

    # previous checkpoint intact, torn state invisible
    steps = _ckpt.list_steps(ckdir)
    assert steps == [1], steps  # exactly the first span's snapshot
    if mode == "mid-save":
        assert any(d.endswith(".tmp") for d in os.listdir(ckdir))
    with open(os.path.join(ckdir, "step_00000001", _ckpt.MANIFEST)) as f:
        json.load(f)  # committed manifest parses

    sess = _session(ck_store_root)
    plan = sess.plan("sssp", source=0)
    ref = sess.run(plan)
    res = sess.run(plan, checkpoint_dir=ckdir, checkpoint_chunk=1,
                   resume=True)
    _same_run(res, ref)


# ------------------------------------------------------- across packages

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(ck_store_root, tmp_path, writer):
    """A snapshot one package wrote seeds the other's resume: the same
    files, manifest and fingerprint, and the resumed run finishes
    bitwise equal to the reference's uninterrupted run."""
    sess = _session(ck_store_root)
    jsess = JGopherSession(JGoFSStore(ck_store_root))
    plan, jplan = sess.plan("sssp", source=0), jsess.plan("sssp", source=0)
    I = sess.num_instances
    assert run_fingerprint(plan, I, 1) == j_run_fingerprint(jplan, I, 1)
    want = jsess.run(jplan)
    d = str(tmp_path / writer)
    if writer == "reference":
        jsess.run(jplan, checkpoint_dir=d, checkpoint_chunk=1)
    else:
        sess.run(plan, checkpoint_dir=d, checkpoint_chunk=1)
    steps = _ckpt.list_steps(d)
    assert steps == j_ckpt.list_steps(d) and len(steps) >= 2
    with open(os.path.join(d, f"step_{steps[0]:08d}", _ckpt.MANIFEST)) as f:
        manifest = json.load(f)
    assert sorted(manifest["leaves"]) == ["final", "local_sweeps",
                                          "supersteps", "values"]
    for s in steps[1:]:
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    if writer == "reference":
        got = sess.run(plan, checkpoint_dir=d, checkpoint_chunk=1,
                       resume=True)
    else:
        got = jsess.run(jplan, checkpoint_dir=d, checkpoint_chunk=1,
                        resume=True)
    for key in ("values", "final"):
        _bits(np.asarray(getattr(got.engine, key)),
              np.asarray(getattr(want.engine, key)), key)
    _bits(np.asarray(got.engine.stats["supersteps"]),
          np.asarray(want.engine.stats["supersteps"]))


# ----------------------------------------------------- two processes

def test_two_process_resumable_run_written_by_process_0(ck_store_root,
                                                        tmp_path,
                                                        monkeypatch):
    """Two in-thread cluster sessions checkpoint one run into one
    directory: only process 0 writes, each snapshot is followed by a
    barrier, and a resume of both peers finishes bitwise equal to the
    uninterrupted single-process run."""
    d = str(tmp_path / "ck")
    writers = []
    real_save = p_cc._ckpt.save

    def save(*a, **k):
        writers.append(threading.current_thread().name)
        return real_save(*a, **k)

    monkeypatch.setattr(p_cc._ckpt, "save", save)
    one = _session(ck_store_root)
    ref = one.run(one.plan("sssp", source=0))

    def body(rt, resume=False):
        sess = _session(ck_store_root, cluster=rt)
        return sess.run(sess.plan("sssp", source=0), checkpoint_dir=d,
                        checkpoint_chunk=1, resume=resume)

    for got in run_peers(body):
        _same_run(got, ref)
    I = one.num_instances
    assert set(writers) == {"peer0"} and len(writers) == I
    with open(os.path.join(d, f"step_{I:08d}", _ckpt.MANIFEST)) as f:
        assert json.load(f)["extra"]["fingerprint"]["num_processes"] == 2
    # keep the first span's snapshot only, then resume both peers from it
    for s in _ckpt.list_steps(d)[1:]:
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    assert _ckpt.list_steps(d) == [1]
    writers.clear()
    for got in run_peers(lambda rt: body(rt, resume=True)):
        _same_run(got, ref)
    assert set(writers) == {"peer0"} and len(writers) == I - 1
