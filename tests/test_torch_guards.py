"""Guards of the PyTorch/CUDA port: it stands apart from JAX and from the
JAX package, it never falls back to the CPU or to the plain version, and
it refuses what it does not run (a grid of more than one rank, 3-axis
meshes included, outside its rank processes; what is not ported yet,
each naming its ROADMAP item).  The LM launchers' ``--mesh`` and
``--grad-compression``, refused until the sharding slice, run."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.core import decomposition as dec
from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import FFT3DPlan, make_fft3d
from repro_torch.configs import get_config
from repro_torch.fleet import cli as fleet_cli
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.serving import SimServer
from repro_torch.serving import cli as serving_cli
from repro_torch.solvers import cli, make_solver

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SERVING = tuple(f"repro_torch.serving.{m}" for m in
                ("cli", "loadgen", "queue", "registry", "request", "server"))
FLEET = tuple(f"repro_torch.fleet.{m}" for m in
              ("cli", "controller", "faults", "records", "worker"))
TRAINING = ("repro_torch.data.pipeline", "repro_torch.optim.adamw",
            "repro_torch.training.train_loop", "repro_torch.launch.train")
SHARDING = ("repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
            "repro_torch.distributed.compression", "repro_torch.launch.mesh")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print('LOADED', bad)\n"
        "print('PORT', sorted(k for k in sys.modules if k.startswith('repro_torch.')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "LOADED []" in out, out
    # the observability, checkpoint, perf-model and tuning modules are among
    # those imported
    for mod in ("repro_torch.obs.tracer", "repro_torch.obs.export",
                "repro_torch.checkpoint.checkpoint", "repro_torch.core.perfmodel",
                "repro_torch.core.topology", "repro_torch.configs.fft_configs",
                "repro_torch.tuning.autotune", "repro_torch.tuning.calibrate",
                "repro_torch.tuning.cli", "repro_torch.tuning.solver",
                *FLEET, *SERVING, *TRAINING, *SHARDING):
        assert f"'{mod}'" in out, out


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert {PORT / "obs" / "tracer.py", PORT / "checkpoint" / "checkpoint.py",
            PORT / "core" / "perfmodel.py", PORT / "core" / "topology.py",
            PORT / "configs" / "fft_configs.py"} <= set(files)
    assert {PORT.joinpath(*m.split(".")[1:]).with_suffix(".py")
            for m in TRAINING + SHARDING} <= set(files)
    tuning = {f.name for f in files if f.parent == PORT / "tuning"}
    assert tuning == {"__init__.py", "autotune.py", "cache.py", "calibrate.py",
                      "cli.py", "solver.py", "space.py", "timing.py"}
    serving = {f"repro_torch.serving.{f.stem}" for f in files
               if f.parent == PORT / "serving" and f.stem != "__init__"}
    assert serving == set(SERVING)
    fleet = {f"repro_torch.fleet.{f.stem}" for f in files
             if f.parent == PORT / "fleet" and f.stem != "__init__"}
    assert fleet == set(FLEET)
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


def test_suite_collects_without_torch():
    # a box without torch (CI's `pip install .[test]`) collects the
    # reference's tests and skips the port's files, each with its reason
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import pytest\n"
            "sys.exit(pytest.main(['--collect-only', '-q', '-rs', '-p', "
            "'no:cacheprovider', '-p', 'no:randomly', 'tests']))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    ports = sorted(p.name for p in (REPO / "tests").glob("test_torch_*.py"))
    skipped = re.findall(r"SKIPPED \[1\] tests/(test_torch_\w+\.py):\d+: "
                         r"could not import 'torch'", r.stdout)
    assert sorted(skipped) == ports, r.stdout[-4000:]
    assert "tests/test_fft3d.py::" in r.stdout  # the reference's tests


def test_fleet_exports_the_reference_names():
    import repro.fleet
    import repro_torch.fleet

    assert repro_torch.fleet.__all__ == repro.fleet.__all__
    for name in repro.fleet.__all__:
        assert hasattr(repro_torch.fleet, name), name


def test_fleet_worker_leaves_jax_and_repro_out(tmp_path, monkeypatch):
    # a real worker attempt of a 1x1 CPU job, run through the controller's
    # worker_argv hook; what the process holds when the job has ended
    from repro_torch.fleet import FleetController, FleetJob

    code = ("import sys\n"
            "from repro_torch.fleet import worker\n"
            "rc = worker.main(sys.argv[1:])\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))\n"
            "print('LOADED', bad, 'SOLVER', 'repro_torch.solvers.heat' in sys.modules)\n"
            "sys.exit(rc)\n")
    monkeypatch.setenv("PYTHONPATH", str(REPO / "src"))
    ctl = FleetController(
        [FleetJob(job_id="j0", case="heat", n=8, steps=2, mesh=(1, 1), device="cpu")],
        workdir=str(tmp_path), total_slots=1, verbose=False,
        worker_argv=(sys.executable, "-c", code))
    res = ctl.run()["j0"]
    log = (tmp_path / "j0.attempt0.log").read_text()
    assert res.ok and sorted(res.history) == [0, 1, 2], log
    assert "LOADED [] SOLVER True" in log, log


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_solver("heat", dec.PencilGrid.from_mesh(1, 1), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fft3d(dec.PencilGrid.from_mesh(1, 1), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--sim", "--case", "heat", "--n", "8", "--mesh", "1x1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_cli.main(["--case", "heat", "--n", "8", "--mesh", "2x2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimServer(dec.PencilGrid.from_mesh(1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_model(get_config("smollm-360m", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_cli.main(["--jobs", "1", "--n", "8", "--submesh", "1x1"])


@pytest.mark.parametrize("pu,pv", [(2, 1), (1, 2), (4, 2)])
def test_multi_rank_grid_raises(pu, pv):
    # outside the rank processes of repro_torch.dist.run_ranks
    grid = dec.PencilGrid.from_mesh(pu, pv)
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_solver("poisson", grid, 8, device="cpu")
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_fft3d(grid, 8, device="cpu")
    plan = FFT3DPlan(n=(8, 8, 8), grid=grid)
    with pytest.raises(RuntimeError, match="run_ranks"):
        sp.grid_sum(plan, torch.zeros(()))
    # a grid dimension over two mesh axes (a 3-axis mesh) runs in its
    # ranks too, and nowhere else
    staged = dec.PencilGrid(pu=4, pv=pv, u_axes=("pod", "data"),
                            u_sizes=(2, 2))
    with pytest.raises(RuntimeError, match="2x2x.* mesh .*run_ranks"):
        make_fft3d(staged, 8, device="cpu")
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_solver("heat", staged, 8, device="cpu")


def test_cli_refuses_what_is_not_ported(capsys, monkeypatch, tmp_path):
    # a mesh the grid does not divide is refused before any rank starts
    assert cli.main(["--case", "heat", "--n", "8", "--mesh", "3x2",
                     "--device", "cpu"]) == 1
    assert "invalid problem for mesh 3x2" in capsys.readouterr().err
    # --autotune is ported: the step is tuned, then run on the winner's plan
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    argv = ["--case", "heat", "--autotune", "--device", "cpu", "--n", "8",
            "--steps", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "autotuned solver step (measured)" in out and "heat: OK" in out
    assert (tmp_path / "plans.json").exists()
    assert cli.main(argv + ["--quiet"]) == 0
    assert "autotuned solver step (cache hit)" in capsys.readouterr().out
    # backend "mxu" is ported: the CLI runs it
    assert cli.main(["--case", "heat", "--n", "16", "--steps", "2",
                     "--backend", "mxu", "--device", "cpu", "--quiet"]) == 0
    assert "heat: OK" in capsys.readouterr().out
    assert cli.main(["--case", "poisson", "--n", "8", "--steps", "1",
                     "--device", "cpu", "--backend", "pallas", "--quiet"]) == 0
    assert "poisson: OK" in capsys.readouterr().out


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    false = shutil.which("false")
    monkeypatch.setattr(_build, "nvcc", lambda: false)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc failed for fft_radix2.cu"):
        _build.build_all(["fft_radix2"])
    assert not list(tmp_path.glob("*.so"))


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _smoke(REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_build_keys_each_source_by_its_headers_and_flags(monkeypatch, tmp_path):
    # only the ring source links the driver API; the others keep their flags
    assert _build._flags("ring_rdma")[-1] == "-lcuda"
    assert _build._flags("fft_mxu") == _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    first = _build._target("k")
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert _build._target("k") != first


def test_what_this_slice_leaves_out_names_its_roadmap_item():
    # the batched step (item 9) is ported: it runs and keeps the lanes
    solver = make_solver("heat", dec.PencilGrid.from_mesh(1, 1), 8, device="cpu")
    stack = tuple(f[None] for f in solver.initial_fields())
    assert [f.shape for f in solver.batched_step(stack)] == [s.shape for s in stack]
    # every refusal left in the port's sources names its ROADMAP item, and
    # none names item 9
    raising = [f for f in sorted(PORT.rglob("*.py"))
               if re.search(r"raise NotImplementedError", f.read_text())]
    assert raising
    for f in raising:
        text = f.read_text()
        assert re.search(r"ROADMAP Queue 1 item (1[0-3]|[1-8])\b|LM_ITEM", text), f
        assert "item 9" not in text, f


@pytest.mark.parametrize("argv,item", [
    (["--arch", "qwen3-moe-30b-a3b"], "Queue 1 item 11"),        # MoE
    (["--arch", "deepseek-v2-lite-16b"], "Queue 1 item 11"),     # MLA + MoE
    (["--arch", "rwkv6-3b"], "Queue 1 item 11"),                 # RWKV
    (["--arch", "jamba-1.5-large-398b"], "Queue 1 item 11"),     # hybrid
    (["--arch", "whisper-small"], "Queue 1 item 11"),            # encdec
    (["--arch", "llava-next-34b"], "Queue 1 item 11"),           # embeds
])
def test_serve_refuses_what_is_not_ported(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(argv + ["--smoke", "--device", "cpu"])


def test_serve_runs_a_mesh():
    # the arguments refused until the sharding slice: 2 rank processes
    argv = ["--smoke", "--device", "cpu"]
    assert torch.equal(serve.main(argv + ["--mesh", "2x1"]),
                       serve.main(argv))


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-moe-30b-a3b"],                             # MoE
    ["--arch", "rwkv6-3b"],                                      # RWKV
])
def test_train_refuses_what_is_not_ported(argv):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        train.main(argv + ["--smoke", "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x1"],
    ["--grad-compression"],   # a DATAxMODEL mesh has no pod axis: the plain step
])
def test_train_runs_what_the_sharding_slice_ports(argv, capsys):
    common = ["--smoke", "--device", "cpu", "--steps", "1"]
    got = train.main(argv + common)
    want = train.main(common)
    assert len(got) == 1 and abs(got[0] - want[0]) <= 1e-5 * abs(want[0])


def test_train_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def test_lm_path_refuses_kv_quant_and_seq_sharded_decode():
    cfg = get_config("smollm-360m", smoke=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        T.init_model(dataclasses.replace(cfg, kv_quant=True), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        T.init_cache(dataclasses.replace(cfg, kv_quant=True), 1, 4, device="cpu")
    # the run context's mesh is a sharding.Mesh; the sequence-sharded
    # decode is not ported
    for field in ("mesh", "seq_shard_kv"):
        with pytest.raises(TypeError, match=field):
            T.RunCfg(**{field: True})
