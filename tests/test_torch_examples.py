"""The port's examples (``examples_torch/``) are part of the contract: each
runs end to end on the CPU in a subprocess, as ``tests/test_examples.py``
runs the reference's, on grids of at most 2 rank processes."""

import os
import subprocess
import sys

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples_torch", script), *args,
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-3000:])
    return out.stdout


def test_quickstart():
    out = _run("quickstart.py", "--n", "16", "--mesh", "2x1")
    assert "quickstart OK" in out and "engine=pallas_ring" in out


def test_navier_stokes():
    out = _run("navier_stokes.py", "--n", "16", "--steps", "3", "--mesh", "1x1")
    assert "energy monotone decay: True" in out


def test_train_lm_short_on_a_mesh():
    out = _run("train_lm.py", "--steps", "30", "--mesh", "2x1")
    assert "loss:" in out


def test_serve_lm():
    out = _run("serve_lm.py", "--mesh", "2x1")
    assert "serve_lm OK" in out
