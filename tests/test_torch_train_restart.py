"""Kill-and-resume of the port's trainer, and resumes across packages.

A mirror of ``tests/test_train_restart.py`` on ``python -m
repro_torch.launch.train --smoke --device cpu``: an uninterrupted run of
12 steps, a run that halts after 7 and a relaunch that resumes it; the
losses at steps 8–11 within 1e-4 of the uninterrupted run's.  Then each
package resumes the other's checkpoint (the JAX trainer's tree and keys):
the next 2 losses within 1e-4 of the other package's uninterrupted run.

Every run is a process of its own (the JAX trainer installs its global
activation rules); the runs that do not wait on each other start at once.
"""

import os
import shutil
import subprocess
import sys

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, HALT, EVERY = 12, 7, 5       # checkpoints at steps 0 and 5 before the halt
NEXT = 2                            # the cross-package resume's steps (6 and 7)
COMMON = ("--arch", "smollm-360m", "--smoke", "--steps", str(STEPS), "--batch",
          "4", "--seq", "64", "--ckpt-every", str(EVERY), "--log-every", "1")


def _start(package, ckpt, extra=()):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    argv = [sys.executable, "-m", f"{package}.launch.train", *COMMON, *extra]
    if ckpt:
        argv += ["--ckpt-dir", ckpt]
    if package == "repro_torch":
        argv += ["--device", "cpu"]
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _losses(stdout):
    out = {}
    for line in stdout.splitlines():
        if line.startswith("step"):
            parts = line.split()
            out[int(parts[1])] = float(parts[3])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    ck = {name: str(tmp / name) for name in ("torch", "jax")}
    first = {
        "torch_ref": _start("repro_torch", ""),
        "jax_ref": _start("repro", ""),
        "torch_halt": _start("repro_torch", ck["torch"], ("--halt-after", str(HALT))),
        "jax_halt": _start("repro", ck["jax"], ("--halt-after", str(HALT))),
    }
    out = {name: _finish(p) for name, p in first.items()}
    # each resume reads a copy: the port's own resume writes on into its dir
    cross = {name: shutil.copytree(path, path + "_copy") for name, path in ck.items()}
    stop = ("--halt-after", str(EVERY + 1 + NEXT))
    second = {
        "torch_resume": _start("repro_torch", ck["torch"]),
        "torch_from_jax": _start("repro_torch", cross["jax"], stop),
        "jax_from_torch": _start("repro", cross["torch"], stop),
    }
    out.update({name: _finish(p) for name, p in second.items()})
    return out


def test_kill_and_resume_continues_trajectory(runs):
    ref = _losses(runs["torch_ref"])
    assert sorted(ref) == list(range(STEPS)) and "[done]" in runs["torch_ref"]
    assert "[halt] simulated crash after step 6" in runs["torch_halt"]
    assert sorted(_losses(runs["torch_halt"])) == list(range(HALT))
    out = runs["torch_resume"]
    assert f"[resume] from step {EVERY}" in out
    got = _losses(out)
    assert sorted(got) == list(range(EVERY + 1, STEPS))
    for step in (8, 9, 10, 11):
        assert abs(got[step] - ref[step]) < 1e-4, (step, got[step], ref[step])


@pytest.mark.parametrize("resumer,writer", [("torch_from_jax", "jax_ref"),
                                            ("jax_from_torch", "torch_ref")])
def test_each_package_resumes_the_others_checkpoint(runs, resumer, writer):
    out = runs[resumer]
    assert f"[resume] from step {EVERY}" in out and "[halt]" in out
    got, ref = _losses(out), _losses(runs[writer])
    steps = list(range(EVERY + 1, EVERY + 1 + NEXT))
    assert sorted(got) == steps
    for step in steps:
        assert abs(got[step] - ref[step]) < 1e-4, (step, got[step], ref[step])
