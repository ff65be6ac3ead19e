"""The row-wise plan of the wire copies (``ring_send``/``ring_land``,
``kernels/ring_rdma.py::copy_plan``), checked on the CPU.  The kernels run
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 3).

For every layout the two copies meet -- block ``dst`` of an input cut along
axis 0, 1 or 2 into a contiguous slot; a slot into block ``src`` of the
merged output along axis 0, 1 or 2; the own block, strided on both sides;
p = 2 and 4; f64 and f32 -- the plan takes 16-byte vectors, and a numpy
mirror of the kernel's row-wise index map (``copy_rows`` in
``csrc/ring_rdma.cu``) on the plan reproduces torch's strided copy bit for
bit.  A base one element off 16 bytes gets the 8-byte case (f64), or the
4-byte one (f32 at an odd offset).
"""

import ctypes

import numpy as np
import pytest

# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.core import transpose as tr
from repro_torch.kernels import ring_rdma

SHAPES = [(8, 12, 16), (3, 8, 20), (4, 6, 64)]
DTYPES = [torch.float64, torch.float32]


def storage_bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of ``t``'s whole storage, as a writable numpy view."""
    st = t.untyped_storage()
    return np.ctypeslib.as_array((ctypes.c_uint8 * st.nbytes()).from_address(st.data_ptr()))


def mirror(width: int, dims, src: torch.Tensor, dst: torch.Tensor) -> None:
    """The kernel's ``copy_rows`` on the plan, in numpy, from src's storage
    into dst's: each row's offsets from the outer dimensions (row-major),
    then its ``size`` elements of ``width`` bytes at the inner strides."""
    *outer, (n, si, di) = dims
    rows = int(np.prod([m for m, _, _ in outer])) if outer else 1
    rest = np.arange(rows)
    so = np.zeros(rows, np.int64)
    do = np.zeros(rows, np.int64)
    for m, sa, sb in reversed(outer[1:]):
        idx = rest % m
        rest = rest // m
        so += idx * sa
        do += idx * sb
    if outer:
        so += rest * outer[0][1]
        do += rest * outer[0][2]
    k = np.arange(n)
    byte = np.arange(width)
    s_at = ((so[:, None] + k * si) * width)[..., None] + byte
    d_at = ((do[:, None] + k * di) * width)[..., None] + byte
    src_b = storage_bytes(src)
    dst_b = storage_bytes(dst)
    s0 = src.data_ptr() - src.untyped_storage().data_ptr()
    d0 = dst.data_ptr() - dst.untyped_storage().data_ptr()
    dst_b[d0 + d_at] = src_b[s0 + s_at]


def layouts(shape, dtype, p, misaligned=False):
    """(kind, src view, dst view) of every copy the wire makes for arrays of
    ``shape`` cut in ``p``: sends along each split axis into a slot, landings
    of a slot and of the own block along each concat axis."""
    g = torch.Generator().manual_seed(sum(shape) + p)
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=g).to(dtype)
    x = flat[1:].view(shape) if misaligned else flat[:n].view(shape)
    out = []
    for axis in range(3):
        if shape[axis] % p:
            continue
        blk = tr.block(x, p - 1, p, axis)
        slot = torch.zeros(blk.shape, dtype=dtype)
        out.append((f"send split={axis}", blk, slot))
        for concat in range(3):
            merged = torch.zeros(tr.merged_shape(x.shape, p, axis, concat), dtype=dtype)
            place = tr.block(merged, 1, p, concat)
            out.append((f"land slot split={axis} concat={concat}",
                        blk.contiguous(), place))
            out.append((f"land own split={axis} concat={concat}", blk, place))
    return out


def _plan(src, dst):
    return ring_rdma.copy_plan(src.shape, src.stride(), dst.stride(),
                               src.element_size(), [src.data_ptr(), dst.data_ptr()])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 4])
def test_plan_takes_vectors_and_mirrors_the_strided_copy(shape, dtype, p):
    cases = layouts(shape, dtype, p)
    assert cases
    for kind, src, dst in cases:
        width, dims = _plan(src, dst)
        *outer, (n, si, di) = dims
        elem = src.element_size()
        # rows whose bytes, and every stride's, are 16-byte multiples move
        # as vectors, 8-byte multiples at least in 8 bytes (aligned bases)
        for w in (16, 8):
            if all((v * elem) % w == 0 for v in (src.shape[-1], *src.stride()[:-1],
                                                   *dst.stride()[:-1])):
                assert width >= w, (kind, dims)
        assert len(dims) <= ring_rdma.MAX_DIMS
        assert n <= ring_rdma.MAX_ROW or (si, di) != (1, 1)
        want = dst.clone()
        want.copy_(src)
        dst.zero_()
        mirror(width, dims, src, dst)
        assert torch.equal(dst, want), kind
        assert dst.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("dtype,width", [(torch.float64, 8), (torch.float32, 4)])
def test_a_misaligned_base_takes_the_element_case(dtype, width):
    # one element past a 16-byte boundary: no vector reaches an aligned
    # address, so f64 moves 8 bytes and f32 4 (an odd f32 offset)
    cases = [c for c in layouts((8, 12, 16), dtype, 4, misaligned=True)
             if "slot" not in c[0]]  # a landed slot is a buffer of its own
    assert len(cases) == 12
    for kind, src, dst in cases:
        assert src.data_ptr() % 16
        w, dims = _plan(src, dst)
        assert w == width, (kind, w)
        want = dst.clone()
        want.copy_(src)
        dst.zero_()
        mirror(w, dims, src, dst)
        assert torch.equal(dst, want), kind


def test_long_contiguous_runs_are_cut_into_rows():
    # a fully contiguous landing (a slot into block 0 of a merge along axis
    # 0) is one run of 8192 f64: 4096 vectors, cut into rows of MAX_ROW
    src = torch.randn(16, 512, dtype=torch.float64)
    dst = torch.zeros(64, 512, dtype=torch.float64)[:16]
    width, dims = _plan(src, dst)
    assert width == 16
    assert dims == [(4096 // ring_rdma.MAX_ROW, ring_rdma.MAX_ROW, ring_rdma.MAX_ROW),
                    (ring_rdma.MAX_ROW, 1, 1)]
    dst.zero_()
    mirror(width, dims, src, dst)
    assert torch.equal(dst, src)


def test_run_a_shapes_take_rows_of_vectors():
    # run (a)'s wire copy: block 1 of a (128, 128, 512) slab cut in 4 along
    # its last axis -- 16384 rows of 1 KB (64 vectors), source stride 4 KB
    x = torch.empty(128, 128, 512, dtype=torch.float64)
    blk = tr.block(x, 1, 4, 2)
    slot = torch.empty(blk.shape, dtype=torch.float64)
    assert _plan(blk, slot) == (16, [(16384, 256, 64), (64, 1, 1)])
    out = torch.empty(128, 512, 128, dtype=torch.float64)
    # its landing: 128 runs of 128 KB (the slot's rows 128 at a time), cut
    # into rows of 4 KB
    assert _plan(slot, tr.block(out, 1, 4, 1)) == (
        16, [(128, 8192, 32768), (32, 256, 256), (256, 1, 1)])


def test_a_strided_inner_dimension_copies_element_by_element():
    # an inner dimension that is not contiguous on both sides (a transpose)
    # keeps the element's width and its strides
    src = torch.randn(6, 10, dtype=torch.float64).t()
    dst = torch.zeros(10, 6, dtype=torch.float64)
    width, dims = _plan(src, dst)
    assert width == 8 and dims[-1] == (6, 10, 1)
    mirror(width, dims, src, dst)
    assert torch.equal(dst, src)
