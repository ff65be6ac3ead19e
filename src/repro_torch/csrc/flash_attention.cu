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
// ridge: tensor-core throughput bounds it.
//
// bf16 (flash_fwd_bf16<DP>), the shape of a Hopper GEMM kernel:
//
//   * Tiles.  One block of 384 threads per (b·h, query tile): two consumer
//     warpgroups and a producer warpgroup.  Each consumer owns 64 query rows
//     and all DP columns of O (a 128-row query tile), except at DP = 256:
//     there both take the same 64 rows and each owns half of O's columns,
//     both computing S.  The reason is registers: ptxas fits the consumers'
//     code in about 168 a thread however many setmaxnreg grants at run
//     time, and O (DP/2 or DP/4 a thread), S and P (BN/2 each) must fit
//     there without spilling.  Key tiles are BN = 128 wide for DP <= 64 and
//     64 for DP >= 128.  The head dimension is padded to DP = 32, 64, 128 or
//     256 inside the tiles.
//   * Loads.  One producer thread issues TMA copies: Q once a block, then K
//     and V tiles into a ring of STAGES (3 for DP <= 64, else 2) in shared
//     memory, each stage with a full and an empty mbarrier.  A 4-D tensor
//     map (D, heads, rows, B) per operand reads q, k and v in place through
//     their strides; rows past S or T and columns past D arrive as zeros.
//     Tiles are stored in 128-byte swizzled atoms of 64 columns (64-byte
//     atoms of 32 columns for DP = 32), the layout wgmma reads.  The
//     producer warpgroup gives up its registers (setmaxnreg 24), the
//     consumers take them (240).
//   * Products.  S = Q K^T is wgmma m64nBNk16 with Q and K both read from
//     shared memory, K-major as they lie.  The TPU kernel keeps p in f32
//     for P V; one bf16 product would round p to 8 bits (the bf16 check
//     refuses that), so p = hi + lo, both bf16, and O += P V is two wgmma
//     calls with A in registers (hi, then lo) against one V descriptor,
//     V MN-major with the transpose bit.  S's accumulator registers become
//     P's A fragments in place.
//   * Softmax in registers, in base 2: p = ex2(s·c - m) with c =
//     log2(e)/sqrt(D) folded into one FMA, m the running max of s·c, ex2
//     the SFU's ex2.approx.ftz (exp2f without its denormal handling);
//     masks only on tiles that cross the diagonal or T.  Key tiles above
//     the causal diagonal are skipped, for the block and for a warpgroup
//     whose rows end before the tile: under the TPU kernel's mask they add
//     exp(-1e30 - m) = 0 and multiply by exp(0) = 1, so skipping them
//     changes no bit.  Heavy (late) causal query tiles are scheduled first.
//   * Epilogue: o = acc / max(l, 1e-30) in bf16, staged in the warpgroup's
//     own part of the Q tile and stored with 16-byte stores (element stores
//     when D % 8 != 0); rows past S are never written.
//
//   What TMA cannot take: a head dimension that is not a multiple of 8, a
//   stride that is not a multiple of 16 bytes, a base that is not 16-byte
//   aligned.  The wrapper (kernels/attention.py) copies such an operand
//   into a zero-padded contiguous (B, T, Hkv, round8(D)) buffer first;
//   `dg` is the operands' head extent, D the true one (scale and output).
//
// f32 (flash_fwd_f32): full-precision CUDA-core FMAs (TF32 would not
// compute the same function), 32-query tiles, scores and the accumulator
// in shared memory.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; links
// libcuda for cuTensorMapEncodeTiled.  The entry point returns a CUDA
// runtime error code, or 10000 + the CUDA driver API's CUresult when a
// tensor map cannot be encoded; it launches on the given stream and does
// not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // attention.py:29
constexpr int THREADS = 128;        // f32 kernel

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
  float scale;        // 1/sqrt(D)
  float scale_log2;   // log2(e)/sqrt(D)
};

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG = 128;                  // threads a warpgroup
constexpr int BF16_THREADS = 3 * WG;     // two consumer warpgroups, one producer
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;       // 128·24 + 256·240 <= 65536

// The consumers' registers: ptxas allocates their code within about 168 a
// thread whatever setmaxnreg grants at run time (spills otherwise), so the
// accumulators are sized to fit: O (DP/2 a thread), S (BN/2) and P (BN/2).
template <int DP>
struct Tile {
  static constexpr int BN = DP <= 64 ? 128 : 64;      // keys a tile
  static constexpr int STAGES = DP <= 64 ? 3 : 2;
  // DP = 256 splits the head dimension: both consumer warpgroups take the
  // same 64 query rows and each accumulates half of O's columns (S is
  // computed by both); otherwise each takes its own 64 rows, all columns
  static constexpr int SPLIT = DP == 256 ? 2 : 1;
  static constexpr int ROWS = 128 / SPLIT;            // query rows a block
  static constexpr int DO = DP / SPLIT;               // O columns a warpgroup
  static constexpr int SW = DP >= 64 ? 128 : 64;      // swizzle span: an atom's row, bytes
  static constexpr int AW = SW / 2;                   // an atom's columns
  static constexpr int NA = DP / AW;                  // atoms across the head dimension
  static constexpr uint32_t MODE = SW == 128 ? 1 : 2; // descriptor swizzle mode
  static constexpr int CH = SW / 16;                  // 16-byte chunks an atom row
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;        // one of K, V in one stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES
                              + 8 * (1 + 2 * STAGES);
};

// 2^x on the SFU (exp2f without its handling of denormal results, which
// are below any p that counts beside the row's largest, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi); two values a register
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// Consumer warpgroup `wg`: 64 query rows from q0w against the block's key
// tiles, then the epilogue.
template <int DP>
__device__ __forceinline__ void consume(const Args& a, unsigned char* Qs,
                                        unsigned char* Ks, unsigned char* Vs,
                                        uint64_t* qbar, uint64_t* full,
                                        uint64_t* empty, int b, int h, int q0,
                                        int ntiles) {
  using C = Tile<DP>;
  constexpr int BN = C::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4, gid = lane / 4, tig = lane % 4;
  const int row0 = C::SPLIT == 1 ? 64 * wg : 0;   // its rows in the block's tile
  const int col0 = C::SPLIT == 1 ? 0 : wg * C::DO; // its first O column
  const int q0w = q0 + row0;
  const bool active = q0w < a.S;     // a warpgroup wholly past S only keeps pace
  const float c = a.scale_log2;

  float o[C::DO / 2];
#pragma unroll
  for (int i = 0; i < C::DO / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = sm90::smem_addr(Qs) + row0 * C::SW;
  sm90::mbar_wait(qbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % C::STAGES;
    const int k0 = i * BN;
    sm90::mbar_wait(&full[st], (i / C::STAGES) & 1);
    if (active && (!a.causal || k0 <= q0w + 63)) {
      const uint32_t k_addr = sm90::smem_addr(Ks + st * C::KV_BYTES);
      const uint32_t v_addr = sm90::smem_addr(Vs + st * C::KV_BYTES);

      // S = Q K^T over DP / 16 steps of 16 columns
      float s[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) s[j] = 0.f;
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const int atom = kc * 16 / C::AW, col = kc * 16 % C::AW;
        const uint64_t dq = sm90::smem_desc(q_addr + atom * C::ROWS * C::SW + col * 2,
                                            16, 8 * C::SW, C::MODE);
        const uint64_t dk = sm90::smem_desc(k_addr + atom * BN * C::SW + col * 2,
                                            16, 8 * C::SW, C::MODE);
        sm90::wgmma_ss<BN>(s, dq, dk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // s[4j + 2hr + e]: row 16w + gid + 8hr, key k0 + 8j + 2tig + e
      if (k0 + BN > a.T || (a.causal && k0 + BN - 1 > q0w)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qpos = q0w + 16 * w + gid + 8 * hr;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + 2 * tig + e;
              if (kpos >= a.T || (a.causal && kpos > qpos)) s[4 * j + 2 * hr + e] = NEG_INF;
            }
          }
        }
      }

      // online softmax, base 2; l stays a per-thread partial sum until the end
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx * c);
        const float alpha = ex2(m[hr] - m_new);
        m[hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * hr + e], c, -m_new));
            s[4 * j + 2 * hr + e] = p;
            sum += p;
          }
        }
        l[hr] = l[hr] * alpha + sum;
#pragma unroll
        for (int j = 0; j < C::DO / 8; ++j) {
          o[4 * j + 2 * hr] *= alpha;
          o[4 * j + 2 * hr + 1] *= alpha;
        }
      }

      // P's A fragments from S's accumulator registers: keys 16kc..16kc+15
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], ph[kc][r], pl[kc][r]);
      }

      // O += P_hi V + P_lo V over BN / 16 steps of 16 keys, V's columns
      // col0 .. col0 + DO
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t dv = sm90::smem_desc(
            v_addr + (col0 / C::AW) * BN * C::SW + kc * 16 * C::SW, BN * C::SW,
            8 * C::SW, C::MODE);
        sm90::wgmma_rs<C::DO>(o, ph[kc], dv);
        sm90::wgmma_rs<C::DO>(o, pl[kc], dv);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }
  if (!active) return;

  // epilogue: o / max(l, 1e-30) as bf16 into this warpgroup's part of the
  // Q tile, same atoms, chunks swizzled; its own reads of Q are done, and
  // split warpgroups share their rows, so they wait for each other first
  if (C::SPLIT > 1) asm volatile("bar.sync 1, %0;\n" :: "n"(2 * WG) : "memory");
  float den[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float t = l[hr];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    den[hr] = fmaxf(t, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < C::DO / 8; ++j) {
    const int d = col0 + 8 * j + 2 * tig;
    const int atom = d / C::AW, ch = (d % C::AW) / 8;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * w + gid + 8 * hr;
      unsigned char* dst = Qs + atom * C::ROWS * C::SW + (row0 + r) * C::SW
                           + ((ch ^ (r % C::CH)) * 16) + (d % 8) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
          o[4 * j + 2 * hr] / den[hr], o[4 * j + 2 * hr + 1] / den[hr]);
    }
  }
  asm volatile("bar.sync %0, %1;\n" :: "r"(2 + wg), "n"(WG) : "memory");

  constexpr int CPR = C::DO / 8;   // 16-byte chunks a row of this warpgroup's
  const int t = threadIdx.x % WG;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
  for (int id = t; id < 64 * CPR; id += WG) {
    const int r = id / CPR, d0 = col0 + (id % CPR) * 8;
    const int qpos = q0w + r;
    if (qpos >= a.S || d0 >= a.D) continue;
    const int atom = d0 / C::AW, ch = (d0 % C::AW) / 8;
    const uint4 val = *reinterpret_cast<const uint4*>(
        Qs + atom * C::ROWS * C::SW + (row0 + r) * C::SW + ((ch ^ (r % C::CH)) * 16));
    __nv_bfloat16* row = op + (((long long)b * a.S + qpos) * a.H + h) * a.D;
    if (a.D % 8 == 0) {
      *reinterpret_cast<uint4*>(row + d0) = val;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
      for (int x = 0; x < 8 && d0 + x < a.D; ++x) row[d0 + x] = e[x];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_fwd_bf16(const Args a, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv) {
  using C = Tile<DP>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms of TMA and wgmma repeat every 1024 bytes
  unsigned char* Qs = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + C::Q_BYTES;                  // stage st at Ks + st·KV_BYTES
  unsigned char* Vs = Ks + C::STAGES * C::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::ROWS;   // heavy causal tiles first
  const int kend = a.causal ? min(a.T, q0 + C::ROWS) : a.T;
  const int ntiles = (kend + C::BN - 1) / C::BN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], 8);   // lane 0 of each consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 8 * 32) {
      sm90::mbar_expect_tx(qbar, C::Q_BYTES);
      for (int at = 0; at < C::NA; ++at)
        sm90::tma_load_4d(Qs + at * C::ROWS * C::SW, &tq, qbar, at * C::AW, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % C::STAGES;
        sm90::mbar_wait(&empty[st], ((i / C::STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int at = 0; at < C::NA; ++at) {
          const int off = st * C::KV_BYTES + at * C::BN * C::SW;
          sm90::tma_load_4d(Ks + off, &tk, &full[st], at * C::AW, hk, i * C::BN, b);
          sm90::tma_load_4d(Vs + off, &tv, &full[st], at * C::AW, hk, i * C::BN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    consume<DP>(a, Qs, Ks, Vs, qbar, full, empty, b, h, q0, ntiles);
  }
}

// 4-D tensor map (dg, heads, rows, B) over a bf16 operand, one box =
// `box_rows` rows of one head, one atom of columns
CUresult encode(CUtensorMap* map, const void* ptr, int dg, int heads, int rows,
                int batch, long long s_head, long long s_row, long long s_batch,
                int atom_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)dg, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)atom_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch_bf16(const Args& a, int dg, cudaStream_t stream) {
  using C = Tile<DP>;
  const CUtensorMapSwizzle sw = C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, a.q, dg, a.H, a.S, a.B, a.sq_h, a.sq_s, a.sq_b, C::AW,
                      C::ROWS, sw);
  if (r == CUDA_SUCCESS)
    r = encode(&tk, a.k, dg, a.Hkv, a.T, a.B, a.sk_h, a.sk_t, a.sk_b, C::AW, C::BN, sw);
  if (r == CUDA_SUCCESS)
    r = encode(&tv, a.v, dg, a.Hkv, a.T, a.B, a.sv_h, a.sv_t, a.sv_b, C::AW, C::BN, sw);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S + C::ROWS - 1) / C::ROWS);
  flash_fwd_bf16<DP><<<grid, BF16_THREADS, C::SMEM, stream>>>(a, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements.  D is the head
// dimension (scale and output width); dg is the operands' head extent
// (bf16: a multiple of 8, D <= dg; the columns past D are zeros).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_t, long long sk_h,
    long long sv_b, long long sv_t, long long sv_h,
    int B, int S, int T, int H, int Hkv, int D, int causal, int dtype,
    int dg, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  Args a{q, k, v, o, sq_b, sq_s, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h,
         B, S, T, H, Hkv, D, causal, static_cast<float>(scale),
         static_cast<float>(scale * 1.4426950408889634)};
  if (dtype == 0) return static_cast<int>(launch_f32(a, stream));
  if (dtype != 1 || dg < D || dg > 256 || dg % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dg <= 32) return launch_bf16<32>(a, dg, stream);
  if (dg <= 64) return launch_bf16<64>(a, dg, stream);
  if (dg <= 128) return launch_bf16<128>(a, dg, stream);
  return launch_bf16<256>(a, dg, stream);
}
