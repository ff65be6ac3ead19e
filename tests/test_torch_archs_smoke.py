"""Per-architecture smoke tests of the port, the counterpart of
``tests/test_archs_smoke.py`` on the port's side only (no JAX): each
architecture the port runs, at its SMOKE config on the CPU, gives finite
logits of the expected shape from its forward; its prefill and then one
decode step give the forward's logits at those positions; it decodes
from a zero cache.  The architectures still refused raise, naming their
ROADMAP item.
"""

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as T

RUN = T.RunCfg(remat=False)
B, S = 2, 16
#: the SMOKE configs compute in f32: prefill and decode against the forward
TOL = 1e-4
REFUSED = ("llava-next-34b", "whisper-small")
RUNS = [a for a in ARCH_IDS if a not in REFUSED]


@pytest.fixture(autouse=True, scope="module")
def _share_the_host():
    # pytest-xdist runs test files side by side, one a core or so: torch's
    # pool on every core then spends its time waiting on the others
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _model(arch, seed):
    cfg = get_config(arch, smoke=True)
    return cfg, T.init_model(cfg, seed=seed, device="cpu")


def _tokens(cfg, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)).astype(np.int64))


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_port_runs_seven_archs_and_refuses_three():
    # named when jamba was refused: eight run now, two are refused
    assert len(RUNS) == 8 and "jamba-1.5-large-398b" in RUNS and set(REFUSED) < set(ARCH_IDS)


@pytest.mark.parametrize("arch", RUNS)
def test_forward_shapes_no_nans(arch):
    cfg, model = _model(arch, 0)
    logits, cache = T.forward(cfg, RUN, model, {"tokens": _tokens(cfg, 0)})
    assert cache is None and logits.shape == (B, S, cfg.vocab)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", RUNS)
def test_prefill_then_decode_matches_forward(arch):
    cfg, model = _model(arch, 2)
    toks = _tokens(cfg, 2)
    full, _ = T.forward(cfg, RUN, model, {"tokens": toks})
    last, cache = T.prefill(cfg, RUN, model, {"tokens": toks[:, :S - 1]}, t_max=S + 4)
    assert last.shape == (B, 1, cfg.vocab) and cache["len"] == S - 1
    assert _rel(last[:, 0], full[:, S - 2]) <= TOL
    logits, cache = T.decode_step(cfg, RUN, model, cache, toks[:, S - 1:])
    assert cache["len"] == S and _rel(logits[:, 0], full[:, S - 1]) <= TOL


@pytest.mark.parametrize("arch", RUNS)
def test_decode_from_zero_cache(arch):
    cfg, model = _model(arch, 3)
    cache = T.init_cache(cfg, B, 8, device="cpu")
    assert cache["len"] == 0 and not any(t.any() for k, t in cache.items() if k != "len")
    logits, cache = T.decode_step(cfg, RUN, model, cache, torch.zeros(B, 1, dtype=torch.long))
    assert logits.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert cache["len"] == 1


@pytest.mark.parametrize("arch", REFUSED)
def test_what_is_not_ported_raises_naming_its_item(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 11\b"):
        T.init_model(cfg, device="cpu")
