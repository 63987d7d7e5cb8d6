"""The port's train loop, checkpoints and training CLI against the JAX
package's, on the CPU:

* a checkpoint written by the reference's ``train_loop`` resumes in the
  port's, and the port's in the reference's; the next steps' losses
  match the other package's uninterrupted run within 1e-4 (float32);
* a 4-step port run killed after its step-2 checkpoint and resumed
  equals the uninterrupted run bit for bit (losses and final params);
* a step that fails before its first in-place write is retried, one
  that fails after it is not;
* ``AsyncCheckpointer``: snapshots, retention, the writer's error on
  ``wait()``;
* ``python -m repro_torch.launch.train`` at ``--reduced --device cpu``
  prints the reference's lines; without ``--device`` it asks for the card
  and raises where there is none.
"""
import re

import numpy as np
import jax
import pytest
import torch

import repro.configs as j_configs
import repro.launch.train as j_train
from repro_torch import configs
from repro_torch.launch import train as t_train
from repro_torch.models import params_to_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig

ARCH = "glm4-9b"
RUN = dict(global_batch=2, seq_len=16, log_every=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(dtype="float32", num_layers=2)
    return (j_configs.get_config(ARCH).reduced().with_overrides(**kw),
            configs.get_config(ARCH).reduced().with_overrides(**kw))


def _losses(out):
    return {h["step"]: h["loss"] for h in out["history"]}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """Two steps in one package, checkpoint, two more in the other; the
    resumed losses equal the writer's own uninterrupted run's."""
    jcfg, cfg = _cfgs()
    from repro.train.optimizer import OptConfig as JOptConfig

    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    joc, oc = JOptConfig(**okw), OptConfig(**okw)

    def ref(steps, d):
        return j_train.train_loop(jcfg, steps=steps, oc=joc, ckpt_dir=d,
                                  ckpt_every=2, **RUN)

    def port(steps, d):
        return t_train.train_loop(cfg, steps=steps, device="cpu", oc=oc,
                                  ckpt_dir=d, ckpt_every=2, **RUN)

    first, second = (ref, port) if writer == "reference" else (port, ref)
    whole = first(4, str(tmp_path / "whole"))
    first(2, str(tmp_path / "split"))
    resumed = second(4, str(tmp_path / "split"))
    assert resumed["resumed_from"] == 2
    want, got = _losses(whole), _losses(resumed)
    assert sorted(got) == [2, 3]
    for s in (2, 3):
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4)


def test_resume_is_bitwise():
    """Killed after the step-2 checkpoint (a 2-step run of the same
    schedule) and resumed: losses and final parameters equal the
    uninterrupted 4-step run's bit for bit."""
    import tempfile

    _, cfg = _cfgs()
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        whole = t_train.train_loop(cfg, steps=4, device="cpu", oc=oc,
                                   ckpt_dir=a, ckpt_every=2, **RUN)
        t_train.train_loop(cfg, steps=2, device="cpu", oc=oc, ckpt_dir=b,
                           ckpt_every=2, **RUN)
        resumed = t_train.train_loop(cfg, steps=4, device="cpu", oc=oc,
                                     ckpt_dir=b, ckpt_every=2, **RUN)
    assert resumed["resumed_from"] == 2
    want, got = _losses(whole), _losses(resumed)
    assert got == {s: want[s] for s in (2, 3)}
    pw, pr = params_to_numpy(whole["params"]), params_to_numpy(
        resumed["params"])
    assert all(np.array_equal(x, y) for x, y in zip(
        jax.tree.leaves(pw), jax.tree.leaves(pr)))
    assert resumed["opt_state"]["step"] == whole["opt_state"]["step"] == 4


def test_train_loop_retries_only_a_step_that_wrote_nothing(monkeypatch):
    """A step whose update fails before its first write is retried and
    gives the uninterrupted run's losses bit for bit; one that fails after
    a write (PartialUpdateError) is raised at once, never applied twice."""
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import PartialUpdateError

    _, cfg = _cfgs()
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    whole = t_train.train_loop(cfg, steps=2, device="cpu", oc=oc, **RUN)
    real, calls = ts.adamw_update, []

    def fail_once(where):
        def update(params, grads, state, *a, **kw):
            calls.append(where)
            if len(calls) == 1:
                grads = list(grads)
                grads[where] = torch.zeros(3)  # fails on leaf ``where``
            return real(params, grads, state, *a, **kw)
        return update

    monkeypatch.setattr(ts, "adamw_update", fail_once(0))
    retried = t_train.train_loop(cfg, steps=2, device="cpu", oc=oc, **RUN)
    assert len(calls) == 3  # step 0 twice, step 1 once
    assert _losses(retried) == _losses(whole)
    calls.clear()
    monkeypatch.setattr(ts, "adamw_update", fail_once(2))
    with pytest.raises(PartialUpdateError):
        t_train.train_loop(cfg, steps=2, device="cpu", oc=oc, **RUN)
    assert len(calls) == 1


def test_async_checkpointer_snapshots_and_retention(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.arange(6.0)
    for step in (1, 2, 3):
        saver.save(step, {"w": w, "n": np.int32(step)})
        w += 1.0  # in place after the snapshot: the checkpoint keeps it
    saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == [2, 3]
    state, step = ckpt.restore(str(tmp_path), {"w": torch.zeros(6),
                                               "n": np.int32(0)})
    assert step == 3 and int(state["n"]) == 3
    assert torch.equal(state["w"], torch.arange(6.0) + 2.0)
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "file"), keep=1)
    (tmp_path / "file").write_text("not a directory")
    bad.save(1, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


def _mask(text):
    """The lines with their numbers masked (weights and timings differ)."""
    return [re.sub(r"[-+]?\d+\.\d+(e[-+]\d+)?", "<n>", ln)
            for ln in text.splitlines()]


def test_train_cli_prints_the_reference_lines(capsys, monkeypatch):
    args = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16"]
    monkeypatch.setattr("sys.argv", ["train"] + args)
    j_train.main()
    want = capsys.readouterr().out
    t_train.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _mask(got) == _mask(want)
    assert got.splitlines()[-1].startswith("[train] done: first loss")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_train.main(args)


def test_train_loop_defaults_to_the_card():
    import inspect

    assert inspect.signature(t_train.train_loop).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        _, cfg = _cfgs()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_train.train_loop(cfg, steps=1, global_batch=1, seq_len=4)
    assert t_train.make_compressor("none") is None
    assert t_train.make_compressor(True).__class__.__name__ == \
        "Int8Compressor"
    assert t_train.make_compressor("topk", topk_frac=0.2).frac == 0.2
    with pytest.raises(ValueError, match="unknown compressor"):
        t_train.make_compressor("fp8")
