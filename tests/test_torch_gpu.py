"""Tests of the port that need a CUDA card (marker ``gpu``; they skip on a
machine without one).  Run them on the card with
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import pytest
import torch

from repro_torch.core import decomposition as dec
from repro_torch.kernels import fft_mxu, fft_radix2, ref
from repro_torch.solvers import make_solver
from repro_torch.solvers.base import observables_rel_err

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,rows", [(2, 64), (8, 37), (512, 300), (8192, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_version(cuda, n, rows, dtype, inverse):
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    xr = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    xi = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    before = fft_radix2.launches
    kr, ki = fft_radix2.fft1d_radix2(xr, xi, inverse=inverse)
    assert fft_radix2.launches == before + 1
    pr, pi = (ref.ifft_dif_planar if inverse else ref.fft_dif_planar)(xr, xi)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale


def test_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(2, 16384, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared"):
        fft_radix2.fft1d_radix2(x, x)
    y = torch.zeros(4, 8, dtype=torch.float64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft_radix2.fft1d_radix2(y, y)


@pytest.mark.parametrize("n,rows", [(4, 64), (16, 37), (512, 300), (8192, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_kernel_matches_plain_version(cuda, n, rows, dtype, inverse):
    # the plain version's products go through cuBLAS: keep TF32 out of them
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    xr = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    xi = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    before = fft_mxu.launches
    kr, ki = fft_mxu.fft1d_mxu(xr, xi, inverse=inverse)
    assert fft_mxu.launches == before + 1
    pr, pi = fft_mxu.four_step_planar(xr, xi, inverse=inverse)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale


def test_mxu_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(2, 16384, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="N <= 8192"):
        fft_mxu.fft1d_mxu(x, x)
    y = torch.zeros(4, 8, dtype=torch.float64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft_mxu.fft1d_mxu(y, y)
    z = torch.zeros(4, 2, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="power of two >= 4"):
        fft_mxu.fft1d_mxu(z, z)


@pytest.mark.parametrize("case", ["heat", "poisson", "nls", "navier_stokes"])
def test_solver_on_card_matches_cpu(cuda, case):
    grid = dec.PencilGrid.from_mesh(1, 1)
    cfg = {"backend": "pallas"}
    calls = ref.calls
    _, gpu_hist = make_solver(case, grid, 16, device=cuda, plan_cfg=cfg).run(2)
    assert ref.calls == calls  # the card path never reaches the plain version
    _, cpu_hist = make_solver(case, grid, 16, device="cpu", plan_cfg=cfg).run(2)
    for a, b in zip(gpu_hist, cpu_hist):
        assert observables_rel_err(a, b) <= 1e-10


def test_mxu_solver_on_card_matches_cpu(cuda):
    grid = dec.PencilGrid.from_mesh(1, 1)
    cfg = {"backend": "mxu", "r2c_packed": True}
    calls, plain, launches = ref.calls, fft_mxu.plain_calls, fft_mxu.launches
    _, gpu_hist = make_solver("heat", grid, 16, device=cuda, plan_cfg=cfg).run(2)
    # the card path launches the kernel and never reaches a plain version
    assert (ref.calls, fft_mxu.plain_calls) == (calls, plain)
    assert fft_mxu.launches > launches
    _, cpu_hist = make_solver("heat", grid, 16, device="cpu", plan_cfg=cfg).run(2)
    for a, b in zip(gpu_hist, cpu_hist):
        assert observables_rel_err(a, b) <= 1e-10
