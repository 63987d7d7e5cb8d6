"""The port's examples (``python -m repro_torch.examples.<name>``) against
the reference's (``examples/<name>.py``), on the CPU.

Each port example runs with its asserts live, and its printed lines —
reached vertices, supersteps, messages, slices read, the plan's fields
and estimates, edge cut, BSP stats, staged bytes, per-timestep tables,
traces — equal the reference example's on the same run, line for line.
Three kinds of line differ by design and are compared by their shape:
the temporary deploy directory, the plan's kernel line (the port's
kernel rule keys on the device; ROADMAP §3) and, for ``serve_lm``, the
generated tokens (the weights come from a ``torch.Generator``; the
prompts from the reference's numpy stream) and the serving timer.
"""
import importlib.util
import inspect
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.examples import (quickstart, serve_lm, temporal_sssp,
                                  vehicle_tracking)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(REPO, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("== 2. deploy to GoFS "):
            ln = "== 2. deploy to GoFS <tmp>"
        elif ln.lstrip().startswith("kernel    = off"):
            ln = ln.split("[auto]")[0] + "[auto] <reason>"
        out.append(ln)
    return out


def _same_lines(capsys, port_main, ref_main, **kw):
    ref_main(**kw)
    want = capsys.readouterr().out
    port_main(device="cpu", **kw)
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    return got


@pytest.mark.parametrize("comm,layout", [(None, None), ("ring", "sparse"),
                                         ("host", None)],
                         ids=["planned", "ring_sparse", "host"])
def test_quickstart_prints_the_reference_lines(capsys, comm, layout):
    got = _same_lines(capsys, quickstart.main, _reference("quickstart").main,
                      comm=comm, layout=layout)
    assert "explicit engine == session bitwise" in got
    assert "sssp identical to the solo run" in got


@pytest.mark.parametrize("comm,layout", [(None, None), ("ring", "sparse"),
                                         ("host", None)],
                         ids=["planned", "ring_sparse", "host"])
def test_temporal_sssp_prints_the_reference_lines(capsys, comm, layout):
    got = _same_lines(capsys, temporal_sssp.main,
                      _reference("temporal_sssp").main,
                      comm=comm, layout=layout)
    assert "== explicit engine bitwise on every timestep" in got
    assert "double-buffered staging: identical distances" in got


def test_vehicle_tracking_prints_the_reference_lines(capsys):
    got = _same_lines(capsys, vehicle_tracking.main,
                      _reference("vehicle_tracking").main)
    assert "engines agree" in got


def test_serve_lm_serves_the_reference_requests(capsys):
    """Six requests of eight new tokens each, the prompts the reference
    example draws (``examples/serve_lm.py``), finite logits; tokens are
    the port's own (random weights from a torch generator)."""
    serve_lm.main(device="cpu")
    got = capsys.readouterr().out.splitlines()
    vocab = get_config("glm4-9b").reduced().vocab_size
    rng = np.random.default_rng(0)  # the reference example's draws
    rng.integers(0, vocab, (2, 12))
    lens = []
    for _ in range(6):
        lens.append(int(rng.integers(4, 16)))
        rng.integers(0, vocab, lens[-1])
    assert got[0].startswith("generate(): [[")
    assert re.fullmatch(r"\[serve\] 6 requests, 48 tokens, .*", got[1])
    for i, ln in enumerate(got[2:5]):
        m = re.fullmatch(rf"req {i} \((\d+) prompt toks\) -> \[(.*)\]", ln)
        assert m and int(m.group(1)) == lens[i], (ln, lens)
        assert len(m.group(2).split(",")) == 8
    assert got[5] == "✓ batched serving"


def test_examples_default_to_the_card():
    """No flag-less example runs on the CPU: ``device`` defaults to
    ``cuda``, which raises where there is no card."""
    for mod in (quickstart, temporal_sssp, vehicle_tracking, serve_lm):
        assert inspect.signature(mod.main).parameters[
            "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_lm.main()
