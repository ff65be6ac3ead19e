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
4-byte one (f32 at an odd offset).  The same holds for the copies of the
staged exchange of a 3-axis mesh (``transpose.staged_exchange`` over two
mesh axes of 2 ranks), whose views of the reshaped block grid have strides
neither the fold nor the unfold makes, and their widths are pinned.
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


# ---------------------------------------------------------------------------
# the staged exchange's copies (3-axis meshes)
# ---------------------------------------------------------------------------

class RecordingWire:
    """A wire of one rank that makes the peer-mapped wire's copies locally
    through the wire's copy wrappers (``IpcWire.exchange``: the own block
    landed; each other block sent into a slot and landed from it; on the
    card the kernels, here plain indexing) and records each copy of the
    first array as ``(kind, src view, dst view)``.  The "peers'" blocks
    are this rank's own."""

    def __init__(self, p: int, me: int, copies: list):
        self.p, self.me, self.copies = p, me, copies

    def exchange(self, arrs, schedule, *, split_axis, concat_axis, between=None):
        p = self.p
        outs = [torch.empty(tr.merged_shape(x.shape, p, split_axis, concat_axis),
                            dtype=x.dtype, device=x.device) for x in arrs]
        for j in range(p):
            place = tr.block(outs[0], j, p, concat_axis)
            if j == self.me:
                own = [tr.block(x, j, p, split_axis) for x in arrs]
                self.copies.append((f"p={p} land own", own[0], place))
                ring_rdma.ring_land(own, outs, j, p, concat_axis)
                continue
            slots = [torch.empty(tr.block(x, j, p, split_axis).shape, dtype=x.dtype,
                                 device=x.device) for x in arrs]
            self.copies.append((f"p={p} send", tr.block(arrs[0], j, p, split_axis),
                                slots[0]))
            ring_rdma.ring_send(arrs, j, p, split_axis, slots)
            self.copies.append((f"p={p} land slot", slots[0], place))
            ring_rdma.ring_land(slots, outs, j, p, concat_axis)
        for r in range(len(schedule)):
            if between is not None:
                between(r)
        return outs


# the u exchanges of the 2x2x2 main path (u over pod and data, 4 ranks), at
# the local shapes of N=16: the fold of an X-pencil slab (a narrowed view,
# split along x, merged along y) and the unfold of a Y-pencil slab through
# its permute (split along its first axis, merged along its last)
STAGED = {"fold_xy": (lambda x: x.narrow(1, 2, 2), (4, 8, 16), 2, 0),
          "unfold_xy": (lambda x: x.permute(2, 1, 0), (4, 2, 16), 0, 2)}
# the plan's width of each copy, in order: the permuted unfold's first
# stage gathers element by element (its inner stride is 32 elements), as
# the single-axis unfold does; every other copy moves 16-byte vectors
STAGED_WIDTHS = {("fold_xy", torch.float64): [16] * 6, ("fold_xy", torch.float32): [16] * 6,
                 ("unfold_xy", torch.float64): [8, 8] + [16] * 4,
                 ("unfold_xy", torch.float32): [4, 4] + [16] * 4}


def staged_layouts(dtype, which, me=(1, 0), device="cpu"):
    """The copies (kind, src, dst) of one staged exchange over mesh axes of
    sizes (2, 2), as rank ``me`` (its pod and data coordinates) makes them,
    and the result, which must be the flat tiled all-to-all's."""
    view, shape, split, concat = STAGED[which]
    g = torch.Generator().manual_seed(len(which))
    x = view(torch.randn(shape, generator=g).to(dtype).to(device))
    copies = []
    wires = tuple(RecordingWire(2, m, copies) for m in me)
    outs, _ = tr.staged_exchange([x], wires, split_axis=split, concat_axis=concat,
                                 exchange=tr.ring_exchange)
    return copies, x, outs[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", list(STAGED))
def test_staged_views_take_a_plan_that_mirrors_the_strided_copy(dtype, which):
    copies, _, _ = staged_layouts(dtype, which)
    # per stage (pod, data): the own block landed, one block sent, one slot
    # landed
    assert len(copies) == 6
    widths = []
    for kind, src, dst in copies:
        width, dims = _plan(src, dst)
        widths.append(width)
        assert len(dims) <= ring_rdma.MAX_DIMS
        want = dst.clone()
        want.copy_(src)
        dst.zero_()
        mirror(width, dims, src, dst)
        assert dst.numpy().tobytes() == want.numpy().tobytes(), kind
    assert widths == STAGED_WIDTHS[(which, dtype)]


def test_staging_reproduces_the_flat_exchange():
    # one rank's view of a staged exchange is the flat tiled all-to-all of
    # the same blocks, whichever rank it is (every block here is its own)
    for which in STAGED:
        for me in ((0, 0), (0, 1), (1, 0), (1, 1)):
            _, x, got = staged_layouts(torch.float64, which, me)
            _, _, split, concat = STAGED[which]
            want = tr.merge_blocks(tr.stack_blocks(x, 4, split), 4, concat)
            assert torch.equal(got, want), (which, me)
