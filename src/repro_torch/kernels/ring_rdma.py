"""The paper's NIC offload (§4.2–4.3) on Hopper: ring exchanges over
peer-mapped device memory, with the butterflies of the travelling data.

Port of ``repro.kernels.ring_rdma``.  There, one Pallas TPU kernel per
exchange runs P−1 double-buffered neighbour DMAs and, between a round's
start and its wait, the radix-2 butterflies of a payload.  Here the same
schedule is driven from the host over three hand-written CUDA kernels of
``csrc/ring_rdma.cu``:

* :func:`ring_send` (for ``nic_take`` and the remote-copy starts) gathers
  block ``dst`` straight from the input's strided layout into a peer's
  landing slot, through the peer's mapped pointer;
* :func:`ring_land` (for ``nic_place``) scatters a landed slot, or the
  own block, into the merged output (``merge_blocks``' rank-major layout);
* :func:`ring_payload` (for ``_payload_chunk``) transforms payload rows:
  forward radix-2, the conjugate-trick inverse, or the roundtrip forward →
  diagonal multiply → inverse.

:class:`IpcWire` is the wire of one grid dimension on the card: each rank
``cudaMalloc``s a landing buffer (one slot per array and source rank) and
``uint32`` flags, and opens its peers' through CUDA IPC, so the ranks of
one card (or of several) write into each other's memory.  Sends go on the
wire's send stream; flags carry epochs that only grow (a stream write
after a send, a stream wait before a landing, and a "slot consumed" epoch
back to the sender before it writes the slot again).

:func:`ring_exchange_rdma` and :func:`ring_exchange_bidi_rdma` mirror the
reference's contract: the relayout of :func:`transpose.ring_exchange`
bit for bit, and with ``payload=`` the payload's rows cut into one chunk a
round (:func:`_chunk_bounds`), each launched after the next round's send
is posted and before the current round is waited on (Fig. 4.3).  Over a
grid dimension that spans several mesh axes they take one wire per axis
and stage the exchange (:func:`transpose.staged_exchange`); the payload
rides the first stage.  Each single-axis exchange meters one ``rdma``
dispatch (:func:`transpose._meter_exchange`).

The copies run row-wise on a plan made here (:func:`copy_plan`): rows of
16-byte vectors where the layout allows, else 8- or 4-byte elements;
``copy_widths`` counts their launches by width.

Each wrapper runs its plain version for tensors that lie on the CPU
(:func:`payload_plain`; plain indexing for take and place) and launches
its kernel for CUDA tensors, or raises.  ``payload_launches``,
``send_launches`` and ``land_launches`` count kernel launches,
``plain_calls`` calls of :func:`payload_plain`; nothing else adds to them
(``shared_diag_launches`` counts the roundtrip launches among
``payload_launches`` whose multiplier several lanes shared,
``payload_copies`` the payloads an exchange had to pack first).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.distributed as tdist

from repro_torch.core import transpose as tr
from repro_torch.kernels import _launch, ref
from repro_torch.kernels.fft_radix2 import check_row_smem, twiddles

payload_launches = 0
send_launches = 0
land_launches = 0
plain_calls = 0
#: packed copies an exchange made of a payload whose rows the kernel cannot
#: read in place (a permuted view); a lane-strided slab needs none
payload_copies = 0
#: roundtrip launches whose multiplier more than one lane shared
shared_diag_launches = 0
#: launches of ring_send and ring_land by the width the plan chose
copy_widths = {16: 0, 8: 0, 4: 0}

_P = ctypes.c_void_p
_PAYLOAD = [_P] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, _P]
_COPY = [ctypes.c_int, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.c_int,
         ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
         ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, _P]
_LIB = _launch.Library("ring_rdma", {
    "ring_payload_f32": _PAYLOAD, "ring_payload_f64": _PAYLOAD,
    "ring_send": _COPY, "ring_land": _COPY,
    "wire_caps": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "wire_alloc": [ctypes.c_ulonglong, ctypes.POINTER(_P)],
    "wire_free": [_P],
    "wire_ipc_handle": [_P, ctypes.c_char_p],
    "wire_ipc_open": [ctypes.c_char_p, ctypes.POINTER(_P)],
    "wire_ipc_close": [_P],
    "wire_signal": [_P, ctypes.c_uint, _P],
    "wire_wait": [_P, ctypes.c_uint, _P],
})

MODES = {"forward": 0, "inverse": 1, "roundtrip": 2}
#: dimensions a copy kernel takes after adjacent dimensions are merged
MAX_DIMS = 6
#: the widths, in bytes, a wire copy moves an element at: a 16-byte vector
#: where the plan allows it, else 8, else the element's own size
COPY_WIDTHS = (16, 8, 4)
#: the longest row of a copy, in elements of its width (4 KB of vectors)
MAX_ROW = 256
_IPC_HANDLE_BYTES = 64
_ALIGN = 256


def use_rdma(device) -> bool:
    """True when exchanges of tensors on ``device`` run on the peer-mapped
    wire (a CUDA device); the gloo wire carries the others."""
    return torch.device(device).type == "cuda"


def fusable_payload(payload) -> bool:
    """True when :func:`ring_payload` can transform this payload: a planar
    (re, im) pair with a power-of-two last axis."""
    if payload is None:
        return False
    pr, pi = payload
    return (pr.shape == pi.shape and pr.dim() >= 1
            and ref.is_pow2(pr.shape[-1]) and pr.shape[-1] >= 2)


def _chunk_bounds(total: int, parts: int, i: int) -> tuple[int, int]:
    """Row range [off, off+cnt) of chunk ``i`` when ``total`` rows are cut
    into ``parts`` near-equal chunks (first ``total % parts`` get +1)."""
    base, rem = divmod(total, parts)
    off = i * base + min(i, rem)
    return off, base + (1 if i < rem else 0)


# ---------------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------------

def lane_rows_of(x) -> int:
    """The rows in the packed run that ends ``x``'s rows (its last axis):
    all of them for a contiguous tensor, one lane's for a slab narrowed
    out of a stack of lanes."""
    n = x.shape[-1]
    if n > 1 and x.stride(-1) != 1:
        return 0
    rows, packed = 1, n
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size != 1 and stride != packed:
            break
        rows *= size
        packed *= size
    return rows


def as_lanes(x, lane_rows: int):
    """``x``'s rows as a ``(lanes, lane_rows, N)`` view whose rows are
    packed within each lane (the lanes at any one stride), or None where
    no such view exists."""
    n = x.shape[-1]
    try:
        v = x.view(-1, lane_rows, n)
    except RuntimeError:
        return None
    packed = (n == 1 or v.stride(2) == 1) and (lane_rows == 1 or v.stride(1) == n)
    return v if packed else None


def payload_plain(pr, pi, twr, twi, diag=None, inverse: bool = False):
    """The plain PyTorch version of :func:`ring_payload`, in the kernel's
    (and ``_payload_chunk``'s) order of operations, on the stages of
    :func:`ref.dif_planar` with the twiddle tables ``twr``/``twi``; a
    ``diag`` of the payload's trailing shape broadcasts over its leading
    lanes, as the kernel's lanes share it."""
    global plain_calls
    plain_calls += 1
    n = pr.shape[-1]
    scale = torch.tensor(1.0 / n, dtype=pr.dtype)
    yr, yi = ref.dif_planar(pr, -pi if inverse else pi, twr, twi)
    if inverse:
        yr, yi = yr * scale, -(yi * scale)
    if diag is not None:
        dr, di = diag
        kr = yr * dr - yi * di
        ki = yr * di + yi * dr
        zr, zi = ref.dif_planar(kr, -ki, twr, twi)
        yr, yi = zr * scale, -(zi * scale)
    return yr, yi


def ring_payload(pr, pi, *, diag=None, inverse: bool = False, out=None):
    """Transform the rows (last axis, a power of two) of a planar payload:
    forward radix-2, or the conjugate-trick inverse (``inverse``), or with
    ``diag`` (a planar multiplier pair) the roundtrip forward → multiply →
    inverse.  ``out`` optionally names the output pair.

    The payload may come in lanes: ``pr``/``pi`` are read as lanes of
    packed rows, the lanes at any one stride (a slab narrowed out of a
    stack of lanes is read in place).  A lane holds ``diag``'s rows (the
    multiplier has the payload's trailing shape and every lane shares it,
    payload row r reading multiplier row r mod its rows), else the rows of
    the packed run that ends the payload (:func:`lane_rows_of`).  ``out``
    takes the same lanes; by default it is a new contiguous pair."""
    global payload_launches, shared_diag_launches
    _launch.check_pair(pr, pi)
    n = pr.shape[-1]
    if not (ref.is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    if diag is not None:
        if inverse:
            raise ValueError("diag (roundtrip mode) needs a forward payload")
        _launch.check_pair(*diag)
        k = diag[0].dim()
        if (diag[0].device != pr.device or k > pr.dim()
                or pr.shape[pr.dim() - k:] != diag[0].shape):
            raise ValueError(f"diag of shape {tuple(diag[0].shape)} on "
                             f"{diag[0].device} for a payload of shape "
                             f"{tuple(pr.shape)} on {pr.device}: the multiplier "
                             "has the payload's trailing shape")
    twr, twi = twiddles(n, pr.dtype, pr.device)
    if _launch.runs_plain("ring_payload", pr):
        yr, yi = payload_plain(pr, pi, twr, twi, diag, inverse)
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    fn = _LIB.fn("ring_payload_" + _launch.dtype_suffix("ring_payload", pr.dtype))
    yr, yi = out if out is not None else (
        torch.empty(pr.shape, dtype=pr.dtype, device=pr.device),
        torch.empty(pi.shape, dtype=pi.dtype, device=pi.device))
    _launch.check_pair(yr, pr)
    if diag is not None:
        _launch.check_contiguous("ring_payload", *diag)
    check_row_smem(n, pr.dtype)
    rows = pr.numel() // n
    _launch.check_rows(rows)
    if rows == 0:
        return yr, yi
    lane_rows = diag[0].numel() // n if diag is not None else lane_rows_of(pr)
    x, y = ([as_lanes(t, lane_rows) if lane_rows else None for t in pair]
            for pair in ((pr, pi), (yr, yi)))
    if (any(v is None for v in (*x, *y)) or x[0].stride() != x[1].stride()
            or y[0].stride() != y[1].stride()):
        raise ValueError("ring_payload reads and writes lanes of packed rows "
                         f"({lane_rows} a lane), the lanes at one stride; got "
                         f"strides {pr.stride()} and {yr.stride()} for shape "
                         f"{tuple(pr.shape)}")
    mode = "roundtrip" if diag is not None else ("inverse" if inverse else "forward")
    dr, di = (d.data_ptr() for d in diag) if diag is not None else (None, None)
    _launch.launch("ring_payload", fn, pr.device, pr.data_ptr(), pi.data_ptr(),
                   twr.data_ptr(), twi.data_ptr(), dr, di, yr.data_ptr(),
                   yi.data_ptr(), rows, lane_rows, x[0].stride(0), y[0].stride(0),
                   n, MODES[mode],
                   detail=f"{mode} rows={rows} in lanes of {lane_rows}, N={n}, "
                          f"{pr.dtype}")
    payload_launches += 1
    shared_diag_launches += diag is not None and rows > lane_rows
    return yr, yi


# ---------------------------------------------------------------------------
# take and place
# ---------------------------------------------------------------------------

def _merge_dims(shape, src_strides, dst_strides):
    """The copy's index space with size-1 dimensions dropped and adjacent
    dimensions merged where both sides are contiguous across them."""
    dims = [(n, a, b) for n, a, b in zip(shape, src_strides, dst_strides) if n != 1]
    merged = dims[:1] or [(1, 0, 0)]
    for n, a, b in dims[1:]:
        pn, pa, pb = merged[-1]
        if pa == a * n and pb == b * n:
            merged[-1] = (pn * n, a, b)
        else:
            merged.append((n, a, b))
    if len(merged) > MAX_DIMS:
        raise ValueError(f"a block copy over {len(merged)} strided dimensions; "
                         f"the kernels take {MAX_DIMS}")
    return merged


def copy_plan(shape, src_strides, dst_strides, elem: int, ptrs):
    """The row-wise plan of a wire copy: ``(width, dims)``.

    ``dims`` is the copy's index space (:func:`_merge_dims`) in elements of
    ``width`` bytes, its innermost dimension the row.  ``width`` is 16 (a
    vector) where the innermost dimension is contiguous on both sides and
    its bytes, every base in ``ptrs`` and every outer stride are multiples
    of 16; else 8 where those allow it (f32 rows); else the element's own
    size.  A contiguous row longer than ``MAX_ROW`` vectors is cut into rows
    of a power of two at most that long."""
    dims = _merge_dims(shape, src_strides, dst_strides)
    n, a, b = dims[-1]
    width = elem
    if a == 1 and b == 1:
        for w in COPY_WIDTHS:
            k = w // elem
            if w <= elem or n % k or any(p % w for p in ptrs) or any(
                    (s * elem) % w for _, sa, sb in dims[:-1] for s in (sa, sb)):
                continue
            width = w
            break
    k = width // elem
    dims = [(m, sa // k, sb // k) for m, sa, sb in dims[:-1]] + [(n // k, a, b)]
    n, a, b = dims[-1]
    if a == 1 and b == 1 and n > MAX_ROW and len(dims) < MAX_DIMS:
        row = MAX_ROW
        while n % row:
            row //= 2
        if row > 1:
            dims[-1:] = [(n // row, row, row), (row, 1, 1)]
    return width, dims


def _copy(entry: str, srcs, dsts, stream) -> int:
    """Launch ``entry`` (ring_send or ring_land) to copy each ``srcs[a]``
    into ``dsts[a]`` (same shapes, any strides); arrays of one layout share
    a launch.  Returns the number of launches."""
    fn = _LIB.fn(entry)
    pairs = list(zip(srcs, dsts))
    for s, d in pairs:
        if s.shape != d.shape or s.dtype != d.dtype or s.device != d.device:
            raise ValueError(f"{entry}: {tuple(s.shape)}/{s.dtype}/{s.device} "
                             f"into {tuple(d.shape)}/{d.dtype}/{d.device}")
        _launch.dtype_suffix(entry, s.dtype)
        _launch.check_rows(s.numel())
    # the kernel takes two arrays of one layout a launch (re and im)
    layouts = {(s.shape, s.stride(), d.stride()) for s, d in pairs}
    parts = [pairs] if len(pairs) <= 2 and len(layouts) == 1 else [[q] for q in pairs]
    launched = 0
    for part in parts:
        s0, d0 = part[0]
        if s0.numel() == 0:
            continue
        width, dims = copy_plan(s0.shape, s0.stride(), d0.stride(),
                                s0.element_size(),
                                [t.data_ptr() for q in part for t in q])
        size, sst, dst = ((ctypes.c_longlong * len(dims))(*col)
                          for col in zip(*dims))
        _launch.launch(entry, fn, s0.device, width,
                       (_P * 2)(*(s.data_ptr() for s, _ in part)),
                       (_P * 2)(*(d.data_ptr() for _, d in part)),
                       len(part), size, sst, dst, len(dims), stream=stream,
                       detail=f"{len(part)} x {tuple(s0.shape)} {s0.dtype}")
        launched += 1
        copy_widths[width] += 1
    return launched


def ring_send(xs, dst: int, p: int, split_axis: int, slots, *, stream=None) -> None:
    """Block ``dst`` of each ``xs[a]`` (cut into ``p`` along ``split_axis``)
    into ``slots[a]``, a contiguous tensor of the block's shape — on the
    card, a peer's landing slot.  For CPU tensors, plain indexing."""
    global send_launches
    views = [tr.block(x, dst, p, split_axis) for x in xs]
    if _launch.runs_plain("ring_send", xs[0]):
        for v, s in zip(views, slots):
            s.copy_(v)
        return
    send_launches += _copy("ring_send", views, slots, stream)


def ring_land(srcs, outs, src: int, p: int, concat_axis: int, *, stream=None) -> None:
    """Each ``srcs[a]`` (a landed slot, or the own block's view of the
    input) into block ``src`` of ``outs[a]`` along ``concat_axis``.  For
    CPU tensors, plain indexing."""
    global land_launches
    views = [tr.block(o, src, p, concat_axis) for o in outs]
    if _launch.runs_plain("ring_land", outs[0]):
        for v, s in zip(views, srcs):
            v.copy_(s)
        return
    land_launches += _copy("ring_land", srcs, views, stream)


# ---------------------------------------------------------------------------
# the wire on the card
# ---------------------------------------------------------------------------

class _DeviceMemory:
    """A typed view of raw device memory, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, shape, dtype: torch.dtype):
        typestr = {torch.float64: "<f8", torch.float32: "<f4"}[dtype]
        self.__cuda_array_interface__ = {
            "data": (ptr, False), "shape": tuple(shape), "typestr": typestr,
            "strides": None, "version": 3}


class IpcWire:
    """The wire of one grid dimension or mesh axis on the card (see the
    module text).

    ``ranks`` are its global ranks in order, ``me`` this rank's index,
    ``group`` their gloo group (used to swap IPC handles and for the
    barriers around freeing), ``label`` its name in the wire counters.
    Flags: ``ready[src]`` at index ``src`` (the epoch whose block from
    ``src`` has landed here) and ``credit[dst]`` at index ``p + dst`` (the
    epoch whose block ``dst`` has consumed from its slot ``me``).
    ``exchanges`` and ``rounds`` count what the wire carried.
    """

    fuses = True

    def __init__(self, group, ranks: list[int], me: int, device: torch.device,
                 label: str):
        self.group, self.ranks, self.me = group, list(ranks), me
        self.label = label
        self.p = len(ranks)
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.exchanges = 0
        self.rounds = 0
        self.epoch = 0
        caps = ctypes.c_int(0)
        self._call("wire_caps", self.device.index, ctypes.byref(caps))
        if not caps.value:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(self.device)} cannot wait on "
                "stream memory values (CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_"
                "WAIT_VALUE_NOR is 0): the peer-mapped wire needs them")
        self.send_stream = torch.cuda.Stream(self.device)
        self._flags = self._share(4 * 2 * self.p)
        self.slot_bytes = 0
        self.slot_arrays = 0
        self._landing = None

    def _call(self, entry: str, *args) -> None:
        with torch.cuda.device(self.device):
            err = _LIB.fn(entry)(*args)
        if err != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {err}")

    def _share(self, nbytes: int) -> list[int]:
        """Allocate ``nbytes`` here, swap IPC handles with the dimension's
        ranks and open theirs: the buffers' addresses, by rank index."""
        ptr = _P()
        self._call("wire_alloc", nbytes, ctypes.byref(ptr))
        handle = ctypes.create_string_buffer(_IPC_HANDLE_BYTES)
        self._call("wire_ipc_handle", ptr, handle)
        handles = [None] * self.p
        tdist.all_gather_object(handles, handle.raw, group=self.group)
        ptrs = []
        for i, h in enumerate(handles):
            if i == self.me:
                ptrs.append(ptr.value)
                continue
            peer = _P()
            self._call("wire_ipc_open", h, ctypes.byref(peer))
            ptrs.append(peer.value)
        return ptrs

    def _release(self, ptrs: list[int]) -> None:
        """Close the peers' handles after every rank is done with them,
        then free this rank's buffer once every peer has closed it."""
        torch.cuda.synchronize(self.device)
        tdist.barrier(group=self.group)
        for i, ptr in enumerate(ptrs):
            if i != self.me:
                self._call("wire_ipc_close", _P(ptr))
        tdist.barrier(group=self.group)
        self._call("wire_free", _P(ptrs[self.me]))

    def reserve(self, slot_bytes: int, arrays: int = 2) -> None:
        """Make every landing slot hold ``slot_bytes``, for ``arrays``
        arrays an exchange (collective over the dimension's ranks, which
        reach it with the same sizes).  The buffer grows to the largest of
        each seen, and holds a slot an array and a source."""
        if slot_bytes <= self.slot_bytes and arrays <= self.slot_arrays:
            return
        slot_bytes = max(-(-slot_bytes // _ALIGN) * _ALIGN, self.slot_bytes)
        arrays = max(arrays, self.slot_arrays)
        if self._landing is not None:
            self._release(self._landing)
        self._landing = self._share(arrays * self.p * slot_bytes)
        self.slot_bytes, self.slot_arrays = slot_bytes, arrays

    def close(self) -> None:
        """Release the landing buffers and flags (collective)."""
        if self._landing is not None:
            self._release(self._landing)
            self._landing = None
        self._release(self._flags)

    def _slot(self, rank: int, a: int, src: int, shape, dtype) -> torch.Tensor:
        """Slot (array ``a``, source ``src``) of rank ``rank``'s landing
        buffer, as a tensor of ``shape``."""
        ptr = self._landing[rank] + (a * self.p + src) * self.slot_bytes
        return torch.as_tensor(_DeviceMemory(ptr, shape, dtype), device=self.device)

    def _flag(self, rank: int, index: int) -> _P:
        return _P(self._flags[rank] + 4 * index)

    def _signal(self, flag: _P, epoch: int, stream) -> None:
        _launch.launch("wire_signal", _LIB.fn("wire_signal"), self.device,
                       flag, epoch, stream=stream)

    def _wait(self, flag: _P, epoch: int, stream) -> None:
        _launch.launch("wire_wait", _LIB.fn("wire_wait"), self.device, flag,
                       epoch, stream=stream)

    def all_to_all(self, arrs, *, split_axis: int, concat_axis: int):
        """All P−1 blocks posted in one round."""
        return self.exchange(arrs, tr.switched_schedule(self.p),
                             split_axis=split_axis, concat_axis=concat_axis)

    def exchange(self, arrs, schedule, *, split_axis: int, concat_axis: int,
                 between=None):
        """Run ``schedule`` as :meth:`transpose.GlooWire.exchange` does:
        round r+1's sends are posted on the send stream, then
        ``between(r)`` runs on the compute stream, then round r's blocks
        are waited on and landed."""
        p, me = self.p, self.me
        d = arrs[0].dim()
        split_axis, concat_axis = split_axis % d, concat_axis % d
        shape = tr.block(arrs[0], 0, p, split_axis).shape
        dtype = arrs[0].dtype
        if len(arrs) > 2:
            raise ValueError(f"the wire carries 1 or 2 arrays, got {len(arrs)}")
        self.reserve(math.prod(shape) * arrs[0].element_size(), len(arrs))
        self.exchanges += 1
        self.rounds += len(schedule)
        self.epoch += 1
        e = self.epoch
        compute = torch.cuda.current_stream(self.device)
        send = self.send_stream
        outs = [torch.empty(tr.merged_shape(x.shape, p, split_axis, concat_axis),
                            dtype=dtype, device=self.device) for x in arrs]
        ring_land([tr.block(x, me, p, split_axis) for x in arrs], outs, me, p,
                  concat_axis, stream=compute)
        send.wait_stream(compute)
        for x in arrs:
            x.record_stream(send)

        def post(offsets):
            for off in offsets:
                dst = (me + off) % p
                if e > 1:  # the slot's previous block has been landed
                    self._wait(self._flag(me, p + dst), e - 1, send)
                ring_send(arrs, dst, p, split_axis,
                          [self._slot(dst, a, me, shape, dtype)
                           for a in range(len(arrs))], stream=send)
                self._signal(self._flag(dst, me), e, send)

        def land(offsets, _posted):
            for off in offsets:
                src = (me - off) % p
                self._wait(self._flag(me, src), e, compute)
                ring_land([self._slot(me, a, src, shape, dtype)
                           for a in range(len(arrs))], outs, src, p,
                          concat_axis, stream=compute)
                self._signal(self._flag(src, p + me), e, compute)

        tr.run_schedule(schedule, post, land, between)
        return outs


# ---------------------------------------------------------------------------
# public contract (mirrors transpose.ring_exchange)
# ---------------------------------------------------------------------------

def _check_fusion(interleave, payload, diag, inverse) -> None:
    if interleave is not None and payload is not None:
        raise ValueError("interleave (a host thunk) and payload (kernel "
                         "butterflies) are exclusive")
    if diag is not None and (payload is None or inverse):
        raise ValueError("diag (roundtrip payload mode) needs a forward payload")


def _rdma(arrs, wire, schedule, *, split_axis, concat_axis, interleave,
          payload, diag, inverse):
    global payload_copies
    if wire is None:  # one rank: nothing travels
        return list(arrs), None
    # one dispatch of the NIC engine covers all of the exchange's rounds
    tr._meter_exchange(wire, len(schedule), arrs, dispatch_kind="rdma",
                       dispatches=1)
    if payload is None:
        return tr.exchange(arrs, wire, schedule, split_axis=split_axis,
                           concat_axis=concat_axis, interleave=interleave)
    if not wire.fuses:
        raise ValueError(f"{type(wire).__name__} carries no payload; pass "
                         "interleave= instead")
    pr, pi = payload
    lead, n = pr.shape[:-1], pr.shape[-1]
    # the payload in lanes of packed rows (a serving batch's lanes, each
    # with the rows of one solo payload), read in place where it can be;
    # a multiplier broadcastable to the solo payload takes its full shape
    # there (a lane is its rows), never the lanes'
    if diag is not None:
        diag = tuple(torch.broadcast_to(d, pr.shape[pr.dim() - d.dim():])
                     for d in diag)
    lane_rows = diag[0].numel() // n if diag is not None else lane_rows_of(pr)
    x = [as_lanes(t, lane_rows) if lane_rows else None for t in (pr, pi)]
    if any(v is None for v in x) or x[0].stride() != x[1].stride():
        payload_copies += 1
        lane_rows = lane_rows or pr.numel() // n
        x = [t.contiguous().view(-1, lane_rows, n) for t in (pr, pi)]
    if diag is not None:  # one lane's multiplier, shared by every lane
        diag = tuple(d.contiguous().view(lane_rows, n) for d in diag)
    qr, qi = (torch.empty(x[0].shape, dtype=pr.dtype, device=pr.device)
              for _ in range(2))

    def between(r):
        off, cnt = _chunk_bounds(lane_rows, len(schedule), r)
        if cnt:
            rng = slice(off, off + cnt)
            ring_payload(x[0][:, rng], x[1][:, rng], inverse=inverse,
                         diag=None if diag is None else (diag[0][rng], diag[1][rng]),
                         out=(qr[:, rng], qi[:, rng]))
    outs = wire.exchange(arrs, schedule, split_axis=split_axis,
                         concat_axis=concat_axis, between=between)
    return outs, (qr.reshape(*lead, n), qi.reshape(*lead, n))


def ring_exchange_rdma(arrs, wire, *, split_axis: int, concat_axis: int,
                       interleave=None, payload=None, diag=None,
                       inverse: bool = False):
    """Tiled ring all-to-all of ``arrs`` through the NIC engine.

    Contract-compatible with :func:`transpose.ring_exchange`: returns
    ``(outs, follow)``, ``follow`` being the ``interleave()`` result or,
    with a ``payload`` pair, the payload transformed by
    :func:`ring_payload` (forward, ``inverse``, or with ``diag`` the
    roundtrip) in one chunk of rows per round.  A payload needs a wire that
    fuses it (``wire.fuses``).  A tuple of per-axis wires (a grid dimension
    over several mesh axes) runs :func:`transpose.staged_exchange`, one
    ring per axis; the payload (or thunk) rides the first stage, later
    stages relay blocks already transformed.
    """
    _check_fusion(interleave, payload, diag, inverse)
    wire = tr.single_wire(wire)
    if isinstance(wire, tuple):
        return tr.staged_exchange(arrs, wire, split_axis=split_axis,
                                  concat_axis=concat_axis,
                                  exchange=ring_exchange_rdma,
                                  interleave=interleave, payload=payload,
                                  diag=diag, inverse=inverse)
    return _rdma(arrs, wire, tr.ring_schedule(wire.p) if wire else [],
                 split_axis=split_axis, concat_axis=concat_axis,
                 interleave=interleave, payload=payload, diag=diag,
                 inverse=inverse)


def ring_exchange_bidi_rdma(arrs, wire, *, split_axis: int, concat_axis: int,
                            interleave=None, payload=None, diag=None,
                            inverse: bool = False):
    """:func:`ring_exchange_rdma` over both ring directions, ⌈(P−1)/2⌉
    rounds (:func:`transpose.bidi_schedule`); the same relayout bit for
    bit, and the same staging over per-axis wires."""
    _check_fusion(interleave, payload, diag, inverse)
    wire = tr.single_wire(wire)
    if isinstance(wire, tuple):
        return tr.staged_exchange(arrs, wire, split_axis=split_axis,
                                  concat_axis=concat_axis,
                                  exchange=ring_exchange_bidi_rdma,
                                  interleave=interleave, payload=payload,
                                  diag=diag, inverse=inverse)
    return _rdma(arrs, wire, tr.bidi_schedule(wire.p) if wire else [],
                 split_axis=split_axis, concat_axis=concat_axis,
                 interleave=interleave, payload=payload, diag=diag,
                 inverse=inverse)
