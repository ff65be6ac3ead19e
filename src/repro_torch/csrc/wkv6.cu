// RWKV-6 ("Finch") WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// lax.scan (src/repro/models/rwkv.py:90, rwkv_time_mix_seq, through
// repro.models.mamba.chunked_time_scan; one step is rwkv_time_mix_step
// :61).  A scan on the hot path becomes a kernel here: as a Python loop
// of torch ops it would be ~6 launches a step, ~393 k for one prefill of
// rwkv6-3b at a 2048-token prompt.  This kernel takes one launch a layer,
// for any number of steps S >= 1: the prefill at S = the prompt, a decode
// step at S = 1.
//
// What it computes, for each batch row b and head h, with the K x K state
// s (row i indexes k's channel, column j v's), all in f32:
//
//   y[t, j] = sum_i r[t, i] * (s[i, j] + u[i] * k[t, i] * v[t, j])
//   s[i, j] <- w[t, i] * s[i, j] + k[t, i] * v[t, j]
//
// y is read from the old state plus the bonus u (.) k v^T, before the decay
// updates the state, as the reference's step does.  r, k, v are
// (B, S, H, K) in the compute dtype (f32 or bf16: upcast in registers,
// which is exact), w (B, S, H, K) f32, u (H, K) f32, the state
// (B, H, K, K) f32; y (B, S, H, K) f32 and the final state (B, H, K, K)
// f32 are written.  All contiguous.  K, the head size, is a template
// parameter: 16 (rwkv6-3b's SMOKE config) and 64 (rwkv6-3b).
//
// The bonus term is one dot a step: sum_i r_i u_i k_i v_j = v_j d with
// d = sum_i r_i u_i k_i, so y[t, j] = sum_i r_i s[i, j] + v_j d.
//
// What bounds it.  At the prefill shape (B = 8, S = 2048, H = 40, K = 64,
// bf16 r, k, v): the bytes are r, k, v (3 x 83.9 MB), w and y
// (2 x 167.8 MB) and the state in and out (2 x 5.2 MB), 597.7 MB, 0.178
// ms at 3.35 TB/s; the operations are 5 f32 flops a state element a step
// (r s: 2; k v: 1; w s + k v: 2) and 5 a (step, head, j) (d: 3 a term;
// v_j d added: 2), 13.63 GFLOP, 0.203 ms at 67 TFLOP/s.  Operations bound
// it, on the CUDA cores.  At S = 1 (a decode step) the state's bytes bound
// it (10.5 MB, 3.1 us).
//
// Design (simple first): one block per (b, h), K threads; thread j owns
// column j of the state in K registers, so the recurrence needs no
// exchange between threads.  CHUNK steps of r, k, w, v and r u k are
// staged in shared memory at a time; each step's d is summed by one
// thread, in index order, from a padded row (conflict-free); three
// barriers a chunk, not a step.  Each thread then walks the chunk's steps,
// reading a step's r_i, k_i and w_i as float4 broadcasts.  The y sum runs
// in four partial sums (another summation order than a plain loop: f32
// roundoff); every step's arithmetic is the same wherever the chunks cut
// the sequence, so a run split in two with the state carried gives the
// whole run's bits.  What limits
// it: B·H blocks of K threads, a few warps an SM (320 blocks of 64 threads
// at B = 8; only 40 at B = 1), so each step's dependent FMAs and shared
// loads are latency-bound, not throughput-bound.
//
// Under autograd the forward also writes the state at every CKPT-th step
// (the state entering steps 0, CKPT, 2 CKPT, ...) into a buffer (B,
// ceil(S / CKPT), H, K, K) f32: the kernel's form of the reference's
// chunked remat of the time scan (mamba.chunked_time_scan, chunks of 256
// there).  A store beside the arithmetic: y and the final state are those
// of the forward without it, bit for bit.  At the training shape (B = 8,
// S = 512, H = 40, K = 64) CKPT = 16 keeps 32 states of 5.24 MB, 168 MB a
// layer; with remat one layer's at a time.  Those stores are this kernel's
// choice, not the function's work: the forward's bound under autograd is
// the one above (at B = 4, S = 512: 78.6 MB, 0.023 ms; 1.70 GFLOP, 0.025
// ms, operations), as the backward's below leaves the checkpoints out.
//
// The backward, wkv6_bwd_kernel.  Given dy (f32) and dS, the final state's
// gradient (zero where it is not used), walk t from S - 1 down to 0 with ds
// = dS; with g_t = sum_j dy_t[j] v_t[j] and b_t = sum_i r_t[i] u[i] k_t[i]:
//
//   dr_t[i] = sum_j s_{t-1}[i, j] dy_t[j] + u[i] k_t[i] g_t
//   dk_t[i] = sum_j ds[i, j] v_t[j]        + r_t[i] u[i] g_t
//   dv_t[j] = sum_i ds[i, j] k_t[i]        + dy_t[j] b_t
//   dw_t[i] = sum_j ds[i, j] s_{t-1}[i, j]
//   du[i]  += r_t[i] k_t[i] g_t
//   ds[i, j] <- w_t[i] ds[i, j] + r_t[i] dy_t[j]     (after the lines above)
//
// and d(state0) = ds at the end.  ds needs no forward state; dr and dw need
// s_{t-1}, which is recomputed from the chunk's checkpoint (never recovered
// as (s_t - k v^T) / w: w = exp(-exp(.)) underflows to 0 in f32).
//
// Design (simple first): one block per (b, h), K threads; thread i owns row
// i of s and of ds in registers, so dr, dk, dw and ds's update are sums and
// products within one thread.  The chunks of CKPT steps are walked from the
// last; a chunk's r, k, w, v and dy are staged in shared memory, its g_t and
// b_t summed once each, by one thread, in index order.  For each step of
// the chunk, last first, the thread reloads row i of the chunk's checkpoint
// (16 float4 loads at K = 64, from L1) and recomputes the c steps before it
// in registers, with the forward's arithmetic (so the states are the
// forward's, bit for bit): the recomputed states live nowhere but in
// registers, at the cost of (CKPT - 1) / 2 = 7.5 steps of 2 flops an
// element on average, against 11 for the step's own gradient.  dv_t, a
// column sum, is the one exchange between threads a step: each thread
// writes ds[i, j] k_t[i] to a padded (K, K + 1) array in shared memory (no
// bank conflict either way), and thread j sums column j in index order (two
// barriers a step).  du is summed over the steps by each thread and written
// per (b, h): the wrapper sums it over b.  No atomics: two runs give the
// same bits, whatever the remat around the call.
//
// What bounds the backward: at B = 8, S = 512, H = 40, K = 64 its work is
// 671,088,640 state-element steps of 11 f32 flops (dr, dk, dv, dw: 2 each;
// ds's update: 3) and 16 flops a (step, head, channel) (g and b, and the u
// terms of dr, dk, du, dv): 7.55 GFLOP, 0.113 ms at 67 TFLOP/s; its bytes,
// r, k, v in bf16, w and dy in f32 read once, dr, dk, dv, dw in f32
// written once, the two states and d(state0), 330 MB, 0.098 ms at 3.35
// TB/s.  Operations bound it; the recompute adds 15 flops an element that
// the function does not need.  Like the forward it is latency-bound: B * H
// blocks of K threads, a few warps an SM.
//
// C interface (no PyTorch headers, bound with ctypes): launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;  // steps staged in shared memory at a time
constexpr int CKPT = 16;   // steps between two checkpoints of the state
static_assert(CHUNK % CKPT == 0, "a checkpoint falls at a step of a staged chunk");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one state element (i, j) of one step: y's term from the old state, then
// the decay and the new k v
__device__ __forceinline__ void element(float& s, float& acc, float ri,
                                        float ki, float wi, float vj) {
  acc = fmaf(ri, s, acc);
  s = fmaf(wi, s, ki * vj);
}

template <typename T, int K>
__global__ void __launch_bounds__(K)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s_in,
                float* __restrict__ y, float* s_out, float* __restrict__ ck,
                int S, int H) {
  __shared__ __align__(16) float rs[CHUNK][K];
  __shared__ __align__(16) float ks[CHUNK][K];
  __shared__ __align__(16) float ws[CHUNK][K];
  __shared__ float vs[CHUNK][K];
  __shared__ float ruk[CHUNK][K + 1];  // r_i u_i k_i; a row's pad: no conflict
  __shared__ float ds[CHUNK];          // d of each step

  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int j = threadIdx.x;

  float st[K];
  const float* sp = s_in + static_cast<long long>(bh) * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = sp[i * K];
  const float uj = u[h * K + j];

  const long long row = static_cast<long long>(H) * K;  // one step
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * K + j;
  const int nck = (S + CKPT - 1) / CKPT;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int n = min(CHUNK, S - t0);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const long long off = base + static_cast<long long>(t0 + c) * row;
      const float kk = to_f32(k[off]);
      const float rr = to_f32(r[off]);
      rs[c][j] = rr;
      ks[c][j] = kk;
      ws[c][j] = w[off];
      vs[c][j] = to_f32(v[off]);
      ruk[c][j] = rr * (uj * kk);
    }
    __syncthreads();
    for (int c = j; c < n; c += K) {  // one thread a step's d
      float d = 0.f;
#pragma unroll 8
      for (int i = 0; i < K; ++i) d += ruk[c][i];
      ds[c] = d;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      if (ck != nullptr && c % CKPT == 0) {  // the state entering step t0 + c
        float* cp = ck + ((static_cast<long long>(b) * nck + (t0 + c) / CKPT) * H + h) *
                             (K * K) + j;
#pragma unroll
        for (int i = 0; i < K; ++i) cp[i * K] = st[i];
      }
      const float vj = vs[c][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        element(st[i + 0], acc0, r4.x, k4.x, w4.x, vj);
        element(st[i + 1], acc1, r4.y, k4.y, w4.y, vj);
        element(st[i + 2], acc2, r4.z, k4.z, w4.z, vj);
        element(st[i + 3], acc3, r4.w, k4.w, w4.w, vj);
      }
      y[base + static_cast<long long>(t0 + c) * row] =
          fmaf(vj, ds[c], (acc0 + acc1) + (acc2 + acc3));
    }
  }
  float* so = s_out + static_cast<long long>(bh) * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) so[i * K] = st[i];
}

template <typename T, int K>
__global__ void __launch_bounds__(K)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ ck,
                    const float* __restrict__ dy, const float* __restrict__ ds_in,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ du_part, float* __restrict__ ds_out,
                    int S, int H) {
  // rows 0..CKPT-1 of red hold b's terms and rows CKPT..2 CKPT-1 g's while
  // a chunk is staged; then, a step at a time, ds[i, j] k_t[i]
  constexpr int RED_ROWS = K > 2 * CKPT ? K : 2 * CKPT;
  __shared__ __align__(16) float rs[CKPT][K];
  __shared__ __align__(16) float ks[CKPT][K];
  __shared__ __align__(16) float ws[CKPT][K];
  __shared__ __align__(16) float vs[CKPT][K];
  __shared__ __align__(16) float dys[CKPT][K];
  __shared__ float red[RED_ROWS][K + 1];
  __shared__ float gs[CKPT], bs[CKPT];

  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int i = threadIdx.x;
  const float ui = u[h * K + i];

  float ds[K];  // row i of the state's gradient
  if (ds_in != nullptr) {
    const float4* dp =
        reinterpret_cast<const float4*>(ds_in + static_cast<long long>(bh) * K * K + i * K);
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = dp[j / 4];
      ds[j] = q.x, ds[j + 1] = q.y, ds[j + 2] = q.z, ds[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) ds[j] = 0.f;
  }
  float du = 0.f;

  const long long row = static_cast<long long>(H) * K;  // one step
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * K + i;
  const int nck = (S + CKPT - 1) / CKPT;
  for (int c0 = nck - 1; c0 >= 0; --c0) {
    const int t0 = c0 * CKPT;
    const int n = min(CKPT, S - t0);
    __syncthreads();  // the previous chunk's reads are done
    for (int c = 0; c < n; ++c) {
      const long long off = base + static_cast<long long>(t0 + c) * row;
      const float kk = to_f32(k[off]);
      const float rr = to_f32(r[off]);
      const float vv = to_f32(v[off]);
      const float yy = dy[off];
      rs[c][i] = rr;
      ks[c][i] = kk;
      ws[c][i] = w[off];
      vs[c][i] = vv;
      dys[c][i] = yy;
      red[c][i] = rr * (ui * kk);
      red[CKPT + c][i] = yy * vv;
    }
    __syncthreads();
    for (int c = i; c < n; c += K) {  // one thread a step's b and g
      float bsum = 0.f, gsum = 0.f;
#pragma unroll 8
      for (int q = 0; q < K; ++q) {
        bsum += red[c][q];
        gsum += red[CKPT + c][q];
      }
      bs[c] = bsum;
      gs[c] = gsum;
    }
    __syncthreads();
    // row i of the state entering step t0
    const float4* cp = reinterpret_cast<const float4*>(
        ck + ((static_cast<long long>(b) * nck + c0) * H + h) * (K * K) + i * K);
    for (int c = n - 1; c >= 0; --c) {
      float s[K];  // row i of the state entering step t0 + c
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const float4 q = cp[j / 4];
        s[j] = q.x, s[j + 1] = q.y, s[j + 2] = q.z, s[j + 3] = q.w;
      }
      for (int q = 0; q < c; ++q) {  // the forward's steps t0 .. t0 + c - 1
        const float wq = ws[q][i], kq = ks[q][i];
#pragma unroll
        for (int j = 0; j < K; j += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&vs[q][j]);
          s[j] = fmaf(wq, s[j], kq * v4.x);
          s[j + 1] = fmaf(wq, s[j + 1], kq * v4.y);
          s[j + 2] = fmaf(wq, s[j + 2], kq * v4.z);
          s[j + 3] = fmaf(wq, s[j + 3], kq * v4.w);
        }
      }
      const float ri = rs[c][i], ki = ks[c][i], wi = ws[c][i], g = gs[c];
      float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[c][j]);
        const float4 y4 = *reinterpret_cast<const float4*>(&dys[c][j]);
        const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
        const float yj[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_r = fmaf(s[j + e], yj[e], a_r);
          a_k = fmaf(ds[j + e], vj[e], a_k);
          a_w = fmaf(ds[j + e], s[j + e], a_w);
          red[i][j + e] = ds[j + e] * ki;
          ds[j + e] = fmaf(wi, ds[j + e], ri * yj[e]);
        }
      }
      const long long off = base + static_cast<long long>(t0 + c) * row;
      dr[off] = fmaf(ui * ki, g, a_r);
      dk[off] = fmaf(ri * ui, g, a_k);
      dw[off] = a_w;
      du = fmaf(ri * ki, g, du);
      __syncthreads();  // every row's ds k_t is in red
      float a_v = 0.f;  // thread i sums column i
#pragma unroll 8
      for (int q = 0; q < K; ++q) a_v += red[q][i];
      dv[off] = fmaf(dys[c][i], bs[c], a_v);
      __syncthreads();  // column i is read before the next step writes red
    }
  }
  du_part[static_cast<long long>(bh) * K + i] = du;
  float4* op = reinterpret_cast<float4*>(ds_out + static_cast<long long>(bh) * K * K + i * K);
#pragma unroll
  for (int j = 0; j < K; j += 4) op[j / 4] = make_float4(ds[j], ds[j + 1], ds[j + 2], ds[j + 3]);
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s_in, void* y, void* s_out, void* ck,
           int B, int S, int H, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  wkv6_kernel<T, K><<<static_cast<unsigned>(blocks), K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<float*>(y), static_cast<float*>(s_out),
      static_cast<float*>(ck), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s_in, void* y, void* s_out, void* ck,
             int B, int S, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s_in, y, s_out, ck, B, S, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s_in, y, s_out, ck, B, S, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the backward's pointers, in the C entry point's order
struct Grads {
  const void *r, *k, *v, *w, *u, *ck, *dy, *ds_in;
  void *dr, *dk, *dv, *dw, *du_part, *ds_out;
};

template <typename T, int K>
int launch_bwd(const Grads& a, int B, int S, int H, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  wkv6_bwd_kernel<T, K><<<static_cast<unsigned>(blocks), K, 0, stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.ck),
      static_cast<const float*>(a.dy), static_cast<const float*>(a.ds_in),
      static_cast<float*>(a.dr), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), static_cast<float*>(a.dw),
      static_cast<float*>(a.du_part), static_cast<float*>(a.ds_out), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const Grads& a, int B, int S, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch_bwd<T, 16>(a, B, S, H, stream);
    case 64:
      return launch_bwd<T, 64>(a, B, S, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_sizes(int B, int S, int H, int ck_steps) {
  return B <= 0 || S <= 0 || H <= 0 || ck_steps != CKPT ||
         static_cast<long long>(B) * H > 2147483647LL;
}

}  // namespace

// dtype: 0 for f32 r, k, v; 1 for bf16.  ck: the checkpoints' buffer (B,
// ceil(S / ck_steps), H, K, K), or null for none; ck_steps must be CKPT
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_in,
                        void* y, void* s_out, void* ck, int B, int S, int H,
                        int K, int ck_steps, int dtype, cudaStream_t stream) {
  if (bad_sizes(B, S, H, ck_steps)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, ck, B, S, H, K, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, ck, B, S, H, K,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the backward: ds_in (B, H, K, K) or null for a zero dS; du_part (B, H, K)
// is du of each batch row; ds_out (B, H, K, K) is d(state0)
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* ck,
                        const void* dy, const void* ds_in, void* dr, void* dk,
                        void* dv, void* dw, void* du_part, void* ds_out, int B,
                        int S, int H, int K, int ck_steps, int dtype,
                        cudaStream_t stream) {
  if (bad_sizes(B, S, H, ck_steps)) return static_cast<int>(cudaErrorInvalidValue);
  const Grads a{r, k, v, w, u, ck, dy, ds_in, dr, dk, dv, dw, du_part, ds_out};
  if (dtype == 0) return dispatch_bwd<float>(a, B, S, H, K, stream);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, B, S, H, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
