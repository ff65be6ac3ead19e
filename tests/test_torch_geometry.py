"""Port parity: engine specs, pencil grids, the comm DAG and the slab rules
of ``repro_torch`` against ``repro``, field for field, including the
inputs both must reject."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.core import comm as jcomm
from repro.core import decomposition as jdec
from repro.core import engine_spec as jspec
from repro.core.fft3d import FFT3DPlan as JPlan
from repro_torch.core import comm, decomposition as dec, engine_spec
from repro_torch.core import transpose as tr
from repro_torch.core.fft3d import DiagonalKernel, FFT3DPlan


def fields(obj, names=None):
    names = names or [f.name for f in dataclasses.fields(obj)]
    return {k: getattr(obj, k) for k in names}


SPEC_CASES = [
    {},
    dict(engine="torus", backend="pallas", schedule="pipelined", chunks=4),
    dict(engine="bidi_ring", schedule="sequential", chunks=8, real=True),
    dict(backend="ref", r2c_packed=True, vector_mode="parallel",
         fused_roundtrip=True),
    dict(engine="overlap_ring", backend="mxu", schedule="pipelined", chunks=1),
]


@pytest.mark.parametrize("kw", SPEC_CASES)
def test_engine_spec_fields_match(kw):
    p, j = engine_spec.EngineSpec(**kw), jspec.EngineSpec(**kw)
    assert fields(p) == fields(j)
    assert p.fabric == j.fabric
    assert fields(p.replace(chunks=3, schedule="pipelined")) == \
        fields(j.replace(chunks=3, schedule="pipelined"))


@pytest.mark.parametrize("kw", [dict(engine="mesh"), dict(schedule="eager"),
                                dict(vector_mode="batched"), dict(chunks=0)])
def test_engine_spec_rejects_the_same_inputs(kw):
    with pytest.raises(ValueError):
        jspec.EngineSpec(**kw)
    with pytest.raises(ValueError):
        engine_spec.EngineSpec(**kw)


def test_tables_match():
    assert engine_spec.ENGINE_FABRIC == jspec.ENGINE_FABRIC
    assert engine_spec.BACKENDS == jspec.BACKENDS
    assert engine_spec.SCHEDULES == jspec.SCHEDULES
    assert engine_spec.VECTOR_MODES == jspec.VECTOR_MODES
    assert comm.ENGINE_NAMES == jcomm.ENGINE_NAMES
    for name in comm.ENGINE_NAMES:
        assert comm.engine_fabric(name) == jcomm.engine_fabric(name)
        spec = engine_spec.EngineSpec(engine=name)
        assert comm.build_engine(spec, dec.PencilGrid(1, 1)).name == name
    with pytest.raises(ValueError):
        comm.engine_fabric("mesh")


GRID_CASES = [dict(pu=1, pv=1), dict(pu=4, pv=2), dict(pu=2, pv=4),
              dict(pu=8, pv=1), dict(pu=4, pv=2, u_sizes=(2, 2)),
              dict(pu=8, pv=4, u_axes=("pod", "data"), u_sizes=(2, 4))]
GRID_FIELDS = ["pu", "pv", "u_axes", "v_axes", "u_sizes", "v_sizes"]


@pytest.mark.parametrize("kw", GRID_CASES)
@pytest.mark.parametrize("n", [(8, 8, 8), (16, 8, 32), (12, 24, 8)])
def test_pencil_grid_geometry_matches(kw, n):
    p, j = dec.PencilGrid(**kw), jdec.PencilGrid(**kw)
    assert fields(p, GRID_FIELDS) == fields(j, GRID_FIELDS)
    assert p.p == j.p
    for dim in ("u", "v"):
        assert p.dim_axes(dim) == j.dim_axes(dim)
        assert p.dim_ranks(dim) == j.dim_ranks(dim)
        assert p.dim_sizes(dim) == j.dim_sizes(dim)
    try:
        j.validate(n)
    except ValueError:
        with pytest.raises(ValueError):
            p.validate(n)
        return
    p.validate(n)
    assert p.x_pencil_local(n) == j.x_pencil_local(n)
    assert p.y_pencil_local(n) == j.y_pencil_local(n)
    assert p.z_pencil_local(n, kx=j.padded_r2c_len(n[0])) == \
        j.z_pencil_local(n, kx=j.padded_r2c_len(n[0]))
    assert p.padded_r2c_len(n[0]) == j.padded_r2c_len(n[0])
    assert p.local_volume_bytes(n) == j.local_volume_bytes(n)
    assert p.local_volume_after_x_bytes(n) == j.local_volume_after_x_bytes(n)


def test_pencil_grid_rejects_the_same_inputs():
    for kw in (dict(pu=4, pv=2, u_sizes=(3,)), dict(pu=2, pv=2, v_sizes=(4,))):
        with pytest.raises(ValueError):
            jdec.PencilGrid(**kw)
        with pytest.raises(ValueError):
            dec.PencilGrid(**kw)
    for g in (dec.PencilGrid(2, 2), jdec.PencilGrid(2, 2)):
        with pytest.raises(ValueError, match="grid dimension"):
            g.dim_axes("w")
    with pytest.raises(ValueError, match="outside"):
        dec.PencilGrid.from_mesh(2, 2, coords=(2, 0))
    assert dec.PencilGrid.from_mesh(4, 2, coords=(3, 1)).coords == (3, 1)


@pytest.mark.parametrize("real", [False, True])
def test_comm_dag_matches(real):
    p, j = dec.fft3d_dag(real), jdec.fft3d_dag(real)
    assert len(p) == len(j) == 2
    for ps, js in zip(p, j):
        assert fields(ps) == fields(js)
        assert (ps.unfold_split, ps.unfold_concat) == \
            (js.unfold_split, js.unfold_concat)
    assert [s.name for s in p.inverse_steps()] == \
        [s.name for s in j.inverse_steps()]
    assert fields(p.step("yz")) == fields(j.step("yz"))
    with pytest.raises(KeyError):
        p.step("zx")
    p.validate(dec.PencilGrid(2, 2))
    bad = dec.CommDAG(steps=(dec.XY_STEP.replace(permute=(0, 0, 1)),))
    jbad = jdec.CommDAG(steps=(jdec.XY_STEP.replace(permute=(0, 0, 1)),))
    for d, g in ((bad, dec.PencilGrid(1, 1)), (jbad, jdec.PencilGrid(1, 1))):
        with pytest.raises(ValueError, match="not a permutation"):
            d.validate(g)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", [(8, 8, 8), (16, 8, 4)])
def test_plan_matches(real, n):
    kw = dict(n=n, real=real, backend="pallas", schedule="pipelined",
              chunks=3, comm_engine="torus", dtype="float64")
    p = FFT3DPlan(grid=dec.PencilGrid(1, 1), **kw)
    j = JPlan(grid=jdec.PencilGrid(1, 1), **kw)
    names = [f.name for f in dataclasses.fields(JPlan) if f.name != "grid"]
    assert fields(p, names) == fields(j, names)
    assert (p.kx, p.kx_keep) == (j.kx, j.kx_keep)
    assert fields(p.spec()) == fields(j.spec())
    with pytest.raises(ValueError):
        FFT3DPlan(grid=dec.PencilGrid(1, 1), n=n, comm_engine="mesh")
    with pytest.raises(ValueError, match="floating"):
        FFT3DPlan(grid=dec.PencilGrid(1, 1), n=n, dtype="int32")


@pytest.mark.parametrize("size,chunks", [(8, 2), (6, 4), (7, 3), (5, 8), (12, 5)])
def test_slab_boundaries_match(size, chunks):
    """The slab rule decides which rows DiagonalKernel.apply(lo, hi) slices:
    the port cuts exactly where the reference does."""
    x = np.arange(2 * size * 3, dtype=np.float64).reshape(2, size, 3)
    seen_p, seen_j = [], []

    def rec(seen):
        def fn(a):
            seen.append(tuple(np.asarray(a)[0, :, 0]))
            return a
        return fn

    out_p = comm.run_chunked(rec(seen_p), (torch.from_numpy(x),), axis=-2,
                             chunks=chunks)
    out_j = jcomm.run_chunked(rec(seen_j), (jnp.asarray(x),), axis=-2,
                              chunks=chunks)
    assert seen_p == seen_j
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_roundtrip_slabs_slice_the_kernel_rows(chunks):
    grid = dec.PencilGrid(1, 1)
    eng = comm.build_engine(engine_spec.EngineSpec(
        schedule="pipelined", chunks=chunks), grid)
    x = torch.arange(6 * 4 * 2, dtype=torch.float64).reshape(6, 4, 2)
    rows = []

    def kernel(zr, zi, lo, hi):
        rows.append((lo, hi))
        return zr, zi

    ident = lambda a, b: (a, b)
    yr, yi = eng.run_roundtrip(dec.YZ_STEP, ident, kernel, ident, (x, -x))
    assert rows == [(i * 6 // chunks, (i + 1) * 6 // chunks)
                    for i in range(chunks)]
    assert torch.equal(yr, x) and torch.equal(yi, -x)


def test_diagonal_kernel_slices_rows():
    dr = torch.arange(4.0).reshape(4, 1, 1).expand(4, 2, 2)
    di = torch.ones(4, 2, 2)
    k = DiagonalKernel(dr=dr, di=di)
    kr, ki = torch.ones(2, 2, 2), torch.zeros(2, 2, 2)
    ar, ai = k.apply(kr, ki, 1, 3)
    assert torch.equal(ar[:, 0, 0], torch.tensor([1.0, 2.0]))
    assert torch.equal(ai, torch.ones(2, 2, 2))
    ones = torch.ones(4, 2, 2)
    rr, ri = DiagonalKernel(dr=dr).apply(ones, ones)
    assert torch.equal(rr, dr) and torch.equal(ri, dr)


def test_single_rank_transpose():
    x = torch.arange(24.0).reshape(2, 3, 4)
    # one rank: no wire, the exchange is the identity
    assert tr.all_to_all_blocks(x, None, split_axis=2, concat_axis=0) is x
    with pytest.raises(ValueError):
        tr.all_to_all_blocks(x, None, split_axis=2, concat_axis=0, mode="mesh")
    # the block layout of the exchanges: stack and merge are inverse views
    xs = tr.stack_blocks(x, 2, 2)
    assert xs.shape == (2, 2, 3, 2)
    assert torch.equal(xs[1], x[..., 2:])
    assert torch.equal(tr.merge_blocks(xs, 2, 2), x)
    assert torch.equal(tr.merge_blocks(xs, 2, 0), torch.cat([x[..., :2], x[..., 2:]]))
    for perm in ((2, 1, 0), (0, 2, 1)):
        got = tr.permute_last3(x[None], perm)
        np.testing.assert_array_equal(
            got.numpy(), np.transpose(x[None].numpy(), (0,) + tuple(1 + i for i in perm)))
