"""The port's perf-model calibration (``repro_torch.tuning.calibrate``)
against the reference's: document validation gives the same verdicts on
the reference's good and bad documents; a document measured on another
substrate (torch, CUDA, device) is never replayed; and a calibration changes
what the model tells the autotuner (chunk choice, candidate ranking, the
wire rate) as ``tests/test_calibrate.py`` shows for the reference.  The
measurement itself runs on a 2×1 grid of rank processes on the CPU, each
fold timed in lockstep (the max over the ranks), through the CLI.
"""

import json
import os

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.tuning import calibrate as jcal
from repro_torch.core import perfmodel as pm
from repro_torch.core import topology as topo
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.tuning import calibrate as cal
from repro_torch.tuning.space import candidate_space


@pytest.fixture(autouse=True)
def _priors():
    pm.set_calibration(None)
    yield
    pm.set_calibration(None)


def synth_doc(engine_overheads=None, backend_weights=None, *, pkg=cal):
    """A valid calibration document for the *current* substrate of ``pkg``."""
    return {
        "schema": pkg.SCHEMA,
        "fingerprint": pkg.substrate_fingerprint(),
        "mesh": "4x2",
        "quick": True,
        "iters": 1,
        "engine_message_overhead_s": dict(engine_overheads or {}),
        "backend_compute_weight": dict(backend_weights or {"jnp": 1.0}),
        "created": "2026-07-31T00:00:00+00:00",
    }


# ---------------------------------------------------------------------------
# document well-formedness + replay discipline
# ---------------------------------------------------------------------------

BAD = {
    "valid": lambda d: d,
    "schema": lambda d: {**d, "schema": "bench-fft/v1"},
    "unknown_engine": lambda d: {**d, "engine_message_overhead_s": {"carrier_pigeon": 1e-6}},
    "unknown_backend": lambda d: {**d, "backend_compute_weight": {"cufft": 1.0}},
    "negative": lambda d: {**d, "engine_message_overhead_s": {"torus": -1.0}},
    "nan": lambda d: {**d, "engine_message_overhead_s": {"torus": float("nan")}},
    "bool": lambda d: {**d, "backend_compute_weight": {"jnp": True}},
    "table_missing": lambda d: {k: v for k, v in d.items()
                                if k != "backend_compute_weight"},
    "table_not_object": lambda d: {**d, "engine_message_overhead_s": [1e-6]},
    "empty": lambda d: {**d, "engine_message_overhead_s": {},
                        "backend_compute_weight": {}},
    "link_ok": lambda d: {**d, "link_bytes_per_s": 12.5e9},
    "link_only": lambda d: {**d, "engine_message_overhead_s": {},
                            "backend_compute_weight": {}, "link_bytes_per_s": 1e9},
    **{f"link_{i}": (lambda d, bad=bad: {**d, "link_bytes_per_s": bad})
       for i, bad in enumerate((-1.0, 0.0, float("nan"), float("inf"), True, "fast"))},
    "fingerprint_missing": lambda d: {k: v for k, v in d.items() if k != "fingerprint"},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_calibration_equals_the_reference(case):
    mine = cal.validate_calibration(BAD[case](synth_doc({"torus": 1e-6})))
    theirs = jcal.validate_calibration(
        BAD[case](synth_doc({"torus": 1e-6}, pkg=jcal)))
    assert mine == theirs
    assert (mine == []) == (case in ("valid", "link_ok", "link_only"))
    assert cal.validate_calibration("nope") == jcal.validate_calibration("nope")


def test_fingerprint_names_the_port_substrate():
    fp = cal.substrate_fingerprint()
    assert tuple(sorted(fp)) == tuple(sorted(cal.FINGERPRINT_KEYS))
    assert fp["torch_version"] == torch.__version__
    assert fp["device_type"] == ("cuda" if torch.cuda.is_available() else "cpu")
    # an incomplete fingerprint is refused, key by key
    for key in cal.FINGERPRINT_KEYS:
        doc = synth_doc({"torus": 1e-6})
        del doc["fingerprint"][key]
        assert cal.validate_calibration(doc) == [f"fingerprint.{key}: missing or empty"]
    # the reference's documents (a JAX fingerprint) are not the port's
    assert any("torch_version" in p for p in cal.validate_calibration(
        synth_doc({"torus": 1e-6}, pkg=jcal)))


def test_save_load_and_foreign_fingerprint_refused(tmp_path):
    path = str(tmp_path / "sub" / "calibration.json")
    doc = synth_doc({"torus": 3e-6}, {"jnp": 1.0, "ref": 4.0})
    assert cal.save_calibration(doc, path) == path
    assert cal.load_calibration(path) == doc
    assert cal.load_active_calibration(path) == doc
    # measured on another substrate: never replayed
    for key, other in (("device_name", "NVIDIA H100 80GB HBM3"),
                       ("device_type", "cuda"), ("torch_version", "0.0.0"),
                       ("cuda_version", "12.8"), ("device_count", 4)):
        foreign = dict(doc, fingerprint={**doc["fingerprint"], key: other})
        cal.save_calibration(foreign, path)
        assert cal.load_calibration(path) == foreign
        assert cal.load_active_calibration(path) is None, key
    # a document the JAX package wrote is foreign too
    cal.save_calibration(synth_doc({"torus": 3e-6}, pkg=jcal), path)
    assert cal.load_active_calibration(path) is None
    with open(path, "w") as f:
        f.write("{not json")
    assert cal.load_calibration(path) is None
    assert cal.load_active_calibration(path) is None
    assert cal.load_active_calibration(str(tmp_path / "missing.json")) is None


def test_default_path_and_lazy_load(tmp_path, monkeypatch):
    monkeypatch.setenv(cal.ENV_VAR, str(tmp_path / "c.json"))
    assert cal.default_calibration_path() == str(tmp_path / "c.json")
    cal.save_calibration(synth_doc({"torus": 7e-5}), str(tmp_path / "c.json"))
    pm.reset_calibration()
    assert pm.message_overhead_s("torus") == pytest.approx(7e-5)
    assert pm.active_calibration()["engine_message_overhead_s"]["torus"] == 7e-5
    doc = synth_doc({"torus": 7e-5})
    doc["fingerprint"]["torch_version"] = "0.0.0"
    cal.save_calibration(doc, str(tmp_path / "c.json"))
    pm.reset_calibration()
    assert pm.message_overhead_s("torus") == pm.ENGINE_MESSAGE_OVERHEAD_S["torus"]
    monkeypatch.delenv(cal.ENV_VAR)
    assert cal.default_calibration_path().endswith(
        os.path.join(".cache", "repro_torch", "calibration.json"))


# ---------------------------------------------------------------------------
# the calibration must change what the model tells the autotuner
# ---------------------------------------------------------------------------

def test_calibration_changes_chunk_choice():
    prior_k = pm.optimal_chunks(1024, 8, 8, comm_engine="pallas_ring")
    prior_cands = pm.chunk_candidates(1024, 8, 8, "pallas_ring")
    assert prior_k > 1  # the trade is live on this problem
    # messages measured 1000x more expensive -> far coarser slabs
    pm.set_calibration(synth_doc({"pallas_ring": 1000 * pm.ENGINE_MESSAGE_OVERHEAD_S[
        "pallas_ring"]}))
    k_slow = pm.optimal_chunks(1024, 8, 8, comm_engine="pallas_ring")
    cands_slow = pm.chunk_candidates(1024, 8, 8, "pallas_ring")
    assert k_slow < prior_k and cands_slow != prior_cands
    # ...and the tuning space consumes the calibrated enumeration
    piped = {c.chunks for c in candidate_space(1024, 8, 8, backends=["jnp"])
             if c.comm_engine == "pallas_ring" and c.schedule == "pipelined"}
    assert piped == set(cands_slow)
    # messages measured cheaper -> finer slabs
    pm.set_calibration(synth_doc({"pallas_ring": 2e-9}))
    assert pm.optimal_chunks(1024, 8, 8, comm_engine="pallas_ring") > k_slow
    # engines the calibration did not measure keep their priors
    assert pm.message_overhead_s("torus") == pm.ENGINE_MESSAGE_OVERHEAD_S["torus"]


def test_calibration_changes_candidate_ranking():
    def ranking():
        cands = list(candidate_space(64, 4, 2, backends=["jnp"]))
        cands.sort(key=lambda c: pm.estimate_plan_seconds(
            64, 4, 2, backend=c.backend, schedule=c.schedule, chunks=c.chunks,
            comm_engine=c.comm_engine, r2c_packed=c.r2c_packed))
        return [c.name for c in cands]

    def est(engine):
        return pm.estimate_plan_seconds(64, 4, 2, comm_engine=engine)

    prior = ranking()
    assert est("pallas_ring") < est("torus")  # under the H100 priors
    pm.set_calibration(synth_doc({"pallas_ring": 5e-1, "bidi_ring": 5e-1}))
    assert ranking() != prior
    assert est("pallas_ring") > est("torus") and est("bidi_ring") > est("torus")
    pm.set_calibration(None)
    assert est("pallas_ring") < est("torus")  # priors restored


def test_calibration_changes_backend_weights_and_the_wire():
    # the H100 priors rank torch.fft ahead of the radix-2 kernel
    assert pm.estimate_plan_seconds(64, 4, 2, backend="pallas") > \
        pm.estimate_plan_seconds(64, 4, 2, backend="jnp")
    pm.set_calibration(synth_doc(backend_weights={"jnp": 1.0, "pallas": 0.5}))
    assert pm.backend_compute_weight("pallas") == 0.5
    assert pm.estimate_plan_seconds(64, 4, 2, backend="pallas") < \
        pm.estimate_plan_seconds(64, 4, 2, backend="jnp")
    assert pm.backend_compute_weight("mxu") == pm.BACKEND_COMPUTE_WEIGHT["mxu"]
    # a wire measured 10x slower makes every wire-bound estimate grow
    pm.set_calibration(None)
    prior = pm.estimate_roundtrip_seconds(256, 8, 8, fused=True, comm_engine="torus")
    pm.set_calibration({**synth_doc(), "link_bytes_per_s": pm.LINK_BYTES_PER_S / 10})
    assert pm.estimate_roundtrip_seconds(256, 8, 8, fused=True,
                                         comm_engine="torus") > prior
    spec = EngineSpec(engine="pallas_ring")
    pm.set_calibration(synth_doc({"pallas_ring": 42e-6}))
    assert topo.NetworkPlan.for_spec(spec, p=64, r=4, f_mhz=180.0) \
        .message_overhead_s == pytest.approx(42e-6)


# ---------------------------------------------------------------------------
# the measurement, through the CLI, on a grid of rank processes
# ---------------------------------------------------------------------------

def test_cli_writes_wellformed_calibration(tmp_path, capfd):
    out_path = str(tmp_path / "calibration.json")
    assert cal.main(["--quick", "--mesh", "2x1", "--device", "cpu", "--iters", "1",
                     "--out", out_path]) == 0
    out = capfd.readouterr().out
    assert out.count("wrote ") == 1 and "message overhead" in out
    with open(out_path) as f:
        doc = json.load(f)
    assert cal.validate_calibration(doc) == []
    assert doc["mesh"] == "2x1" and doc["quick"] is True
    assert doc["fingerprint"] == cal.substrate_fingerprint("cpu")
    assert set(doc["engine_message_overhead_s"]) <= set(pm.ENGINE_MESSAGE_OVERHEAD_S)
    assert doc["backend_compute_weight"]["jnp"] == 1.0
    assert set(doc["backend_compute_weight"]) == {"jnp", "ref", "pallas", "mxu"}
    # one rank measures nothing that needs a fold: the priors stand for it
    assert cal.run_calibration(cal_grid(1, 1), quick=True, iters=1,
                               device="cpu")["engine_message_overhead_s"] == {}


def test_backend_weights_take_a_dtype():
    w = cal.measure_backend_weights(rows=4, length=16, iters=1, dtype="float64",
                                    device="cpu")
    assert set(w) == {"jnp", "ref", "pallas", "mxu"} and w["jnp"] == 1.0
    with pytest.raises(ValueError, match="real floating"):
        cal.measure_backend_weights(rows=4, length=16, iters=1, dtype="int32",
                                    device="cpu")


def cal_grid(pu, pv):
    from repro_torch.core.decomposition import PencilGrid
    return PencilGrid.from_mesh(pu, pv)
