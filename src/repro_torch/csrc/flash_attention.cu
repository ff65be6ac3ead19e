// Causal or full GQA flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py
// (flash_attention :68, _kernel :32).  It computes what that kernel does:
//
//   s   = (q_f32 . k_f32^T) * (1/sqrt(D))        per q head h and kv head h / g
//   s   = -1e30 where causal and kpos > qpos     (top-left aligned diagonal)
//   online softmax over key blocks: f32 running max m, sum l, accumulator acc
//   acc = acc * exp(m_old - m_new) + exp(s - m_new) . v_f32
//   o   = acc / max(l, 1e-30), stored in q's type
//
// q is (B, S, H, D), k and v are (B, T, Hkv, D), read through their strides
// (the head dimension must be contiguous); o is a contiguous (B, S, H, D).
// H % Hkv == 0 and query head h reads kv head h / (H / Hkv).  D <= 256.
//
// What bounds it: at the LM prefill's shapes (S = T = 2048, D = 64) the two
// products do 2·S·T·D flops per head (half of it under the causal mask)
// against 2·(S + 2T)·D bytes a head, far above the card's ~295 flop/byte
// ridge: tensor-core throughput bounds it.  The design:
//
//   * bf16 (flash_fwd_bf16): one 128-thread block per (b·h, 64-query tile),
//     each warp owning 16 query rows; K and V tiles of 64 keys go through
//     shared memory; S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16
//     in, f32 accumulate).  The TPU kernel keeps p in f32 for P V; a bf16
//     product would round p to 8 bits, so p is split as p = hi + lo, both
//     bf16, and P V is two products (16 significant bits of p).  The head
//     dimension is zero-padded inside the tiles to 32, 64, 128 or 256.
//   * f32 (flash_fwd_f32): full-precision CUDA-core FMAs (TF32 would not
//     compute the same function), 32-query tiles, scores and the
//     accumulator in shared memory.
//   * Key tiles strictly above the causal diagonal are skipped: under the
//     TPU kernel's mask they add exp(-1e30 - m) = 0 and multiply by
//     exp(0) = 1, so skipping them changes no bit.  Heavy (late) causal
//     query tiles are scheduled first.
//
// Not yet done (a later PR): wgmma, TMA loads, double-buffered tiles,
// ldmatrix fragment loads.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.  The entry
// point returns a CUDA error code; it launches on the given stream and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // attention.py:29
constexpr int THREADS = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq_b, sq_s, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  int B, S, T, H, Hkv, D;
  int causal;
  int vec;        // 16-byte loads allowed (D % 8 == 0, strides % 8 == 0, aligned)
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BK = 64;   // keys per tile
static_assert(BQ == BK, "load_tile_bf16 moves tiles of BQ rows");

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi); two values a register
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [r0, r0 + 64) of a (nrows, D) bf16 matrix with row stride rs into a
// (64, LD) shared tile; rows past nrows and columns in [D, DP) are zeros
template <int DP>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               long long rs, int r0, int nrows,
                                               int D, int vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;   // 16-byte chunks a row
    for (int c = threadIdx.x; c < BQ * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < nrows && d < D)
        val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + d);
      *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
    }
  } else {
    for (int c = threadIdx.x; c < BQ * DP; c += THREADS) {
      const int r = c / DP, d = c % DP;
      uint16_t val = 0;
      if (r0 + r < nrows && d < D) val = src[(long long)(r0 + r) * rs + d];
      dst[r * LD + d] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(Args a) {
  constexpr int LD = DP + 8;   // pitch in elements: 16 bytes of padding a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Ks = Qs + BQ * LD;
  uint16_t* Vs = Ks + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const uint16_t* qp = static_cast<const uint16_t*>(a.q) + b * a.sq_b + h * a.sq_h;
  const uint16_t* kp = static_cast<const uint16_t*>(a.k) + b * a.sk_b + hk * a.sk_h;
  const uint16_t* vp = static_cast<const uint16_t*>(a.v) + b * a.sv_b + hk * a.sv_h;

  load_tile_bf16<DP>(Qs, qp, a.sq_s, q0, a.S, a.D, a.vec);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + gid;        // this thread's rows: r0 and r0 + 8

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int kend = a.causal ? min(a.T, q0 + BQ) : a.T;
  const int ntiles = (kend + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // the last tile's reads are done
    load_tile_bf16<DP>(Ks, kp, a.sk_t, k0, a.T, a.D, a.vec);
    load_tile_bf16<DP>(Vs, vp, a.sv_t, k0, a.T, a.D, a.vec);
    __syncthreads();

    // S = Q K^T: 8 tiles of 16 x 8 (keys j*8 .. j*8+7)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      const uint16_t* qa = Qs + r0 * LD + kc * 16 + tig * 2;
      const uint32_t af[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                              ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint16_t* kb = Ks + (j * 8 + gid) * LD + kc * 16 + tig * 2;
        const uint32_t bf[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(s[j], af, bf);
      }
    }

    // scale, mask, online softmax (row r0: e = 0, 1; row r0 + 8: e = 2, 3)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q0 + r0 + 8 * hr;
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + tig * 2 + e;
          float x = s[j][2 * hr + e] * a.scale;
          if (kpos >= a.T || (a.causal && kpos > qpos)) x = NEG_INF;
          s[j][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[hr] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * hr + e] - mx);
          s[j][2 * hr + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = mx;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        acc[i][2 * hr] *= alpha;
        acc[i][2 * hr + 1] *= alpha;
      }
    }

    // O += P V over 4 chunks of 16 keys; P's A fragments are S's C fragments
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ahi[4], alo[4];
      split2(s[2 * kc][0], s[2 * kc][1], ahi[0], alo[0]);
      split2(s[2 * kc][2], s[2 * kc][3], ahi[1], alo[1]);
      split2(s[2 * kc + 1][0], s[2 * kc + 1][1], ahi[2], alo[2]);
      split2(s[2 * kc + 1][2], s[2 * kc + 1][3], ahi[3], alo[3]);
      const uint16_t* vb = Vs + (kc * 16 + tig * 2) * LD + gid;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const uint16_t* c = vb + i * 8;
        const uint32_t bf[2] = {pack(c[0], c[LD]), pack(c[8 * LD], c[9 * LD])};
        mma_bf16(acc[i], ahi, bf);
        mma_bf16(acc[i], alo, bf);
      }
    }
  }

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + r0 + 8 * hr;
    if (qpos >= a.S) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* row = op + (((long long)b * a.S + qpos) * a.H + h) * a.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = i * 8 + tig * 2 + e;
        if (d < a.D) row[d] = __float2bfloat16_rn(acc[i][2 * hr + e] / den);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (DP + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_bf16<DP><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FQ = 32;   // query rows per block
constexpr int FK = 32;   // keys per tile

__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long rs, int r0, int nrows, int D) {
  for (int c = threadIdx.x; c < FQ * D; c += THREADS) {
    const int r = c / D, d = c % D;
    dst[r * ld + d] = (r0 + r < nrows) ? src[(long long)(r0 + r) * rs + d] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Args a) {
  extern __shared__ __align__(16) float smf[];
  const int D = a.D, LQ = D + 1;       // +1: conflict-free rows in the score loop
  float* Qs = smf;                     // FQ x LQ
  float* Ks = Qs + FQ * LQ;            // FK x LQ
  float* Vs = Ks + FK * LQ;            // FK x D
  float* Acc = Vs + FK * D;            // FQ x D
  float* Ss = Acc + FQ * D;            // FQ x (FK + 1)
  float* Ms = Ss + FQ * (FK + 1);
  float* Ls = Ms + FQ;
  float* As = Ls + FQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * FQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk_b + hk * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv_b + hk * a.sv_h;
  const int tid = threadIdx.x;

  load_tile_f32(Qs, LQ, qp, a.sq_s, q0, a.S, D);
  for (int c = tid; c < FQ * D; c += THREADS) Acc[c] = 0.f;
  if (tid < FQ) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  const int kend = a.causal ? min(a.T, q0 + FQ) : a.T;
  const int ntiles = (kend + FK - 1) / FK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * FK;
    __syncthreads();
    load_tile_f32(Ks, LQ, kp, a.sk_t, k0, a.T, D);
    load_tile_f32(Vs, D, vp, a.sv_t, k0, a.T, D);
    __syncthreads();
    for (int c = tid; c < FQ * FK; c += THREADS) {
      const int i = c / FK, j = c % FK;
      const float* qr = Qs + i * LQ;
      const float* kr = Ks + j * LQ;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * a.scale;
      const int kpos = k0 + j;
      if (kpos >= a.T || (a.causal && kpos > q0 + i)) x = NEG_INF;
      Ss[i * (FK + 1) + j] = x;
    }
    __syncthreads();
    if (tid < FQ) {
      float* sr = Ss + tid * (FK + 1);
      float mx = Ms[tid];
      for (int j = 0; j < FK; ++j) mx = fmaxf(mx, sr[j]);
      const float alpha = expf(Ms[tid] - mx);
      float sum = 0.f;
      for (int j = 0; j < FK; ++j) {
        const float p = expf(sr[j] - mx);
        sr[j] = p;
        sum += p;
      }
      Ls[tid] = Ls[tid] * alpha + sum;
      Ms[tid] = mx;
      As[tid] = alpha;
    }
    __syncthreads();
    for (int c = tid; c < FQ * D; c += THREADS) {
      const int i = c / D, d = c % D;
      const float* pr = Ss + i * (FK + 1);
      float pv = 0.f;
      for (int j = 0; j < FK; ++j) pv = fmaf(pr[j], Vs[j * D + d], pv);
      Acc[c] = Acc[c] * As[i] + pv;
    }
  }
  __syncthreads();
  float* op = static_cast<float*>(a.o);
  for (int c = tid; c < FQ * D; c += THREADS) {
    const int i = c / D, d = c % D;
    const int qpos = q0 + i;
    if (qpos < a.S)
      op[(((long long)b * a.S + qpos) * a.H + h) * D + d] = Acc[c] / fmaxf(Ls[i], 1e-30f);
  }
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = (2 * FQ * (a.D + 1) + 2 * FQ * a.D + FQ * (FK + 1) + 3 * FQ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + FQ - 1) / FQ, a.B * a.H);
  flash_fwd_f32<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_t, long long sk_h,
    long long sv_b, long long sv_t, long long sv_h,
    int B, int S, int T, int H, int Hkv, int D, int causal, int dtype,
    int vec, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, sq_b, sq_s, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h,
         B, S, T, H, Hkv, D, causal, vec,
         static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(a, stream);
  } else if (dtype == 1) {
    if (D <= 32) err = launch_bf16<32>(a, stream);
    else if (D <= 64) err = launch_bf16<64>(a, stream);
    else if (D <= 128) err = launch_bf16<128>(a, stream);
    else err = launch_bf16<256>(a, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
