// The paper's NIC offload for Hopper (sm_90a): the ring exchange of pencil
// blocks between rank processes over peer-mapped device memory, with the
// butterflies of the data that travels with it.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ring_rdma.py:
//   ring_send_kernel    <- nic_take (:88, _nic_take_kernel :73) and the
//                          remote-copy starts of _rdma_ring_kernel (:182)
//                          and _rdma_bidi_kernel (:248): xs.at[dst] ->
//                          remote outs.at[me] (:221-222, :296-297);
//   ring_land_kernel    <- nic_place (:101, _nic_place_kernel :78) and the
//                          own-block copy (:211-214);
//   ring_payload_kernel <- _payload_chunk (:153), the compute that runs
//                          between a round's start and its wait.
//
// The wire.  Each rank process cudaMallocs a landing buffer (one slot per
// (array, source rank)) and an array of uint32 flags, and opens its peers'
// through CUDA IPC (wire_ipc_*): ranks on one card share it, ranks on
// several cards reach each other peer to peer.  ring_send gathers block
// `dst` straight from the un-stacked input's strided layout (the
// stack_blocks copy folded into the gather) and stores it contiguously
// into the peer's slot `me` through the peer-mapped pointer.  ring_land
// scatters a landed slot (or the own block, straight from the input) into
// the merged output, merge_blocks' rank-major layout.  Both move each
// element once: bound by bytes, 2 * bytes over the HBM rate on one card,
// where a copy reads and writes the same memory.
//
// The semaphores.  The TPU kernel's send_sem/recv_sem (:223-224,
// :298-299) become stream memory operations on the flags (wire_signal:
// cuStreamWriteValue32 with the default flags, which put a memory barrier
// before the write; wire_wait: cuStreamWaitValue32 GEQ).  Flags hold
// epochs that only grow, so nothing is reset between exchanges.  The
// stream front end waits, not an SM: a kernel spinning on a flag set by
// another process would stall for whole time slices, because kernels of
// different processes are time-sliced on one card.
//
// The payload.  The radix-2 row engine of fft_radix2.cu
// (radix2_stages.cuh: three DIF stages a pass in registers, one XOR
// swizzle that keeps every shared-memory access free of bank conflicts,
// the twiddles staged once a block, several rows a block on a persistent
// grid): mode 0 forward; mode 1 the conjugate-trick inverse with 1/N;
// mode 2 roundtrip -- forward, complex multiply by the diag row in natural
// order, inverse -- reading x and diag once and writing once.  In the
// roundtrip the inverse passes run on the bit-reversed layout of the
// forward output, so the diag multiply rides on their first pass's reads
// (natural order, diag read coalesced from device memory) and no reorder
// runs between the two transforms.  Bound by bytes: 6 * rows * N *
// sizeof(T) in roundtrip mode, 4 * rows * N * sizeof(T) otherwise.
//
// C interface (no PyTorch headers, bound with ctypes).  Runtime errors come
// back as their cudaError_t, driver errors as minus their CUresult; entry
// points that enqueue work take the stream last.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix2_stages.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kForward = 0, kInverse = 1, kRoundtrip = 2;

// One block of up to two arrays (blockIdx.y picks the array): `count`
// elements in row-major order over size[0..ndim), at the element strides
// src_stride/dst_stride from src[a]/dst[a].
struct BlockCopy {
  const void* src[2];
  void* dst[2];
  long long src_stride[kMaxDims];
  long long dst_stride[kMaxDims];
  unsigned size[kMaxDims];
  int ndim;
  unsigned count;
};

template <typename E>
__device__ __forceinline__ void copy_block(const BlockCopy& c) {
  const E* __restrict__ src = static_cast<const E*>(c.src[blockIdx.y]);
  E* __restrict__ dst = static_cast<E*>(c.dst[blockIdx.y]);
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < c.count;
       i += stride) {
    unsigned rest = i;
    long long so = 0, d_o = 0;
    for (int d = c.ndim - 1; d > 0; --d) {
      const unsigned idx = rest % c.size[d];
      rest /= c.size[d];
      so += idx * c.src_stride[d];
      d_o += idx * c.dst_stride[d];
    }
    so += rest * c.src_stride[0];
    d_o += rest * c.dst_stride[0];
    dst[d_o] = src[so];
  }
}

template <typename E>
__global__ void ring_send_kernel(BlockCopy c) {
  copy_block<E>(c);
}

template <typename E>
__global__ void ring_land_kernel(BlockCopy c) {
  copy_block<E>(c);
}

template <typename T, int L, bool kDiag>
__global__ void __launch_bounds__(radix2::Shape<L>::THREADS, 1)
    ring_payload_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                        const T* __restrict__ twr, const T* __restrict__ twi,
                        const T* __restrict__ dr, const T* __restrict__ di,
                        T* __restrict__ yr, T* __restrict__ yi, long long rows,
                        int inverse, T scale) {
  radix2::rows<T, L, kDiag>(xr, xi, twr, twi, dr, di, yr, yi, rows, inverse,
                            scale);
}

template <typename T, bool kDiag, int L>
int payload_launch(const void* xr, const void* xi, const void* twr,
                   const void* twi, const void* dr, const void* di, void* yr,
                   void* yi, long long rows, int n, int mode, void* stream) {
  const long long blocks =
      radix2::grid_for<T, L, 1 + kDiag>(ring_payload_kernel<T, L, kDiag>, rows);
  if (blocks < 0) return static_cast<int>(-blocks);
  ring_payload_kernel<T, L, kDiag>
      <<<static_cast<unsigned>(blocks), radix2::Shape<L>::THREADS,
         radix2::Table<T, L>::smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xr), static_cast<const T*>(xi),
          static_cast<const T*>(twr), static_cast<const T*>(twi),
          static_cast<const T*>(dr), static_cast<const T*>(di),
          static_cast<T*>(yr), static_cast<T*>(yi), rows, mode == kInverse,
          static_cast<T>(1.0 / n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int payload(const void* xr, const void* xi, const void* twr, const void* twi,
            const void* dr, const void* di, void* yr, void* yi,
            long long rows, int n, int mode, void* stream) {
  if (mode != kForward && mode != kInverse && mode != kRoundtrip)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return radix2::with_log2n<radix2::max_log2n<T>()>(log2n, [&](auto l) {
    constexpr int L = decltype(l)::value;
    return mode == kRoundtrip
               ? payload_launch<T, true, L>(xr, xi, twr, twi, dr, di, yr, yi,
                                            rows, n, mode, stream)
               : payload_launch<T, false, L>(xr, xi, twr, twi, dr, di, yr, yi,
                                             rows, n, mode, stream);
  });
}

template <typename Kernel>
int copy(Kernel kernel, const BlockCopy& c, int n_arrays, void* stream) {
  const unsigned threads = 256;
  unsigned blocks = (c.count + threads - 1) / threads;
  if (blocks > 132u * 16u) blocks = 132u * 16u;
  if (blocks == 0) return 0;
  kernel<<<dim3(blocks, static_cast<unsigned>(n_arrays)), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// Fills a BlockCopy from the caller's arrays; false if they do not fit.
bool block_copy(const void* const* src, void* const* dst, int n_arrays,
                const long long* size, const long long* src_stride,
                const long long* dst_stride, int ndim, BlockCopy* c) {
  if (n_arrays < 1 || n_arrays > 2 || ndim < 1 || ndim > kMaxDims) return false;
  long long count = 1;
  for (int d = 0; d < ndim; ++d) {
    c->size[d] = static_cast<unsigned>(size[d]);
    c->src_stride[d] = src_stride[d];
    c->dst_stride[d] = dst_stride[d];
    count *= size[d];
  }
  if (count > 0x7fffffffLL) return false;
  for (int a = 0; a < n_arrays; ++a) {
    c->src[a] = src[a];
    c->dst[a] = dst[a];
  }
  c->ndim = ndim;
  c->count = static_cast<unsigned>(count);
  return true;
}

int send_or_land(bool send, int elem_bytes, const void* const* src,
                 void* const* dst, int n_arrays, const long long* size,
                 const long long* src_stride, const long long* dst_stride,
                 int ndim, void* stream) {
  BlockCopy c;
  if (!block_copy(src, dst, n_arrays, size, src_stride, dst_stride, ndim, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 8)
    return send ? copy(ring_send_kernel<unsigned long long>, c, n_arrays, stream)
                : copy(ring_land_kernel<unsigned long long>, c, n_arrays, stream);
  if (elem_bytes == 4)
    return send ? copy(ring_send_kernel<unsigned>, c, n_arrays, stream)
                : copy(ring_land_kernel<unsigned>, c, n_arrays, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ring_payload_f32(const void* xr, const void* xi, const void* twr,
                                const void* twi, const void* dr, const void* di,
                                void* yr, void* yi, long long rows, int n,
                                int mode, void* stream) {
  return payload<float>(xr, xi, twr, twi, dr, di, yr, yi, rows, n, mode, stream);
}

extern "C" int ring_payload_f64(const void* xr, const void* xi, const void* twr,
                                const void* twi, const void* dr, const void* di,
                                void* yr, void* yi, long long rows, int n,
                                int mode, void* stream) {
  return payload<double>(xr, xi, twr, twi, dr, di, yr, yi, rows, n, mode, stream);
}

// Block `dst` of each input (its strided view: size/src_stride) into the
// contiguous slot at dst[a] -- on a peer, through its mapped pointer.
extern "C" int ring_send(int elem_bytes, const void* const* src,
                         void* const* dst, int n_arrays, const long long* size,
                         const long long* src_stride,
                         const long long* dst_stride, int ndim, void* stream) {
  return send_or_land(true, elem_bytes, src, dst, n_arrays, size, src_stride,
                      dst_stride, ndim, stream);
}

// A landed slot (or the own block) into its place in the merged output.
extern "C" int ring_land(int elem_bytes, const void* const* src,
                         void* const* dst, int n_arrays, const long long* size,
                         const long long* src_stride,
                         const long long* dst_stride, int ndim, void* stream) {
  return send_or_land(false, elem_bytes, src, dst, n_arrays, size, src_stride,
                      dst_stride, ndim, stream);
}

// Whether the card waits on stream memory values (the wire's semaphores).
extern "C" int wire_caps(int device, int* wait_value_nor) {
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  CUdevice dev;
  r = cuDeviceGet(&dev, device);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  r = cuDeviceGetAttribute(wait_value_nor,
                           CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR,
                           dev);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// A zeroed device buffer of its own allocation, so that its IPC handle maps
// exactly this pointer.
extern "C" int wire_alloc(unsigned long long bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int wire_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

extern "C" int wire_ipc_handle(void* ptr, void* handle) {
  return static_cast<int>(
      cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr));
}

extern "C" int wire_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int wire_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Semaphore post: after the stream's earlier work, a memory barrier, then
// *addr = value.
extern "C" int wire_signal(void* addr, unsigned value, void* stream) {
  CUresult r = cuStreamWriteValue32(static_cast<CUstream>(stream),
                                    reinterpret_cast<CUdeviceptr>(addr), value,
                                    CU_STREAM_WRITE_VALUE_DEFAULT);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// Semaphore wait: the stream's later work waits until *addr >= value.
extern "C" int wire_wait(void* addr, unsigned value, void* stream) {
  CUresult r = cuStreamWaitValue32(static_cast<CUstream>(stream),
                                   reinterpret_cast<CUdeviceptr>(addr), value,
                                   CU_STREAM_WAIT_VALUE_GEQ);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}
