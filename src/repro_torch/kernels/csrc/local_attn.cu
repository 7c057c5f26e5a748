// Causal sliding-window (local) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/local_attn.py::_local_attn_kernel
// (reached through local_attention's pl.pallas_call and the wrapper
// kernels/ops.py::local_attn).  q, k, v, out are (BH, S, D), f32 or bf16;
// for each head b and query position qp:
//
//   out[b, qp] = softmax_kp(s[qp, kp]) @ v[b],  kept iff qp - window < kp <= qp
//   s = <q_qp, k_kp> / sqrt(D), then softcap * tanh(s / softcap) if softcap != 0
//
// with an online softmax (running max m, sum l, accumulator acc) in f32 and
// the output written in q's dtype.  Masked scores are the finite -1e30 of
// the reference: a row whose first visited tile is fully masked gathers
// exp(0) = 1 weights there, and alpha = exp(-1e30 - m) = 0 wipes them when
// the row's first kept key arrives (its own diagonal at the latest), exactly
// as on the TPU.  l is floored at 1e-30.
//
// Bound: operations.  4*D per kept (query, key) pair at the bf16 tensor-core
// rate (989 TFLOP/s dense), against 3 reads of (BH, S, D) and one write; at
// D = 128 that is ~170 operations per byte, far over the ridge.
//
// bf16: tensor cores (local_attn_tc_kernel).  A block owns kBqT = 128 query
// rows of one head: two consumer warpgroups of 64 rows each and one producer
// warpgroup, of which one thread issues TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle, tensor maps built on the host per call).  Q is loaded
// once; K and V tiles of BK keys (128 at D <= 128, 64 at D = 256) go through
// a ring of kStages stages, each with a full and an empty mbarrier.  The
// block walks only the kv tiles that intersect [q0 - window + 1, q0 + kBqT);
// a warpgroup skips (but still releases) a tile that is masked for all of
// its rows.  Per tile and warpgroup:
//   S = Q.K^T     wgmma m64 n{BK} k16, Q and K from shared memory (K-major)
//   softmax       in registers in the accumulator's layout, in the log2
//                 domain; row max over the 4 threads of a row; the mask is
//                 applied only on tiles that cross the diagonal, the
//                 window's lower edge or S; softcap is IEEE tanhf
//   O += P.V      wgmma m64 n{D} k16, A = P from registers, B = V from
//                 shared memory (MN-major, transposed)
// P is split into two bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// and both go into O: V is exact in bf16, so P.V keeps ~16 bits of P where
// one bf16 rounding keeps 8 (too few for the model-shape tolerance), at
// 1.5x the MMA work.  setmaxnreg gives the consumers 240 registers and the
// producer 24; O at D = 256 is 128 f32 registers a thread.  Rows past S
// arrive as TMA zeros, keys past S are masked, and output rows qp >= S are
// not stored.
//
// f32: scalar (local_attn_kernel, unchanged from the first port).  Grid
// (query tiles of kBq rows, BH), kThreads threads per block.  A block
// stages its query tile once, then walks only the kv tiles of kBk keys that
// intersect [q0 - window + 1, q0 + kBq).  Each kv tile is staged in shared
// memory.  Thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3:
// it computes the 4 x 4 scores of those rows against keys tx + 16*j in
// registers, reduces row max and row sum over its 16 lanes with shuffles,
// writes the probabilities to a shared P tile, and accumulates P @ V into
// its 4 x D/16 slice of acc (columns tx + 16*c) in registers.  Q and K rows
// are padded to an odd stride (D + 1) so the column-wise reads of 16
// different rows hit 16 different banks.  Shared memory: ~66 KB at D = 64,
// ~113 KB at D = 128, ~209 KB at D = 256 (of 227 KB).  TF32 could not hold
// the f32 tolerance, so this path stays off the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 query rows each
constexpr int kPs = kBk + 1;   // P tile stride
constexpr float kNegInf = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline void store(float* p, float x) { *p = x; }

constexpr size_t smem_floats(int d) {
  return (size_t)kBq * (d + 1) + (size_t)kBk * (d + 1) + (size_t)kBk * d +
         (size_t)kBq * kPs;
}

// Rows [0, valid) of a (kBk or kBq, D) tile from src, zeros past them.
template <typename T, int D>
__device__ inline void stage(float* dst, int stride, const T* src,
                             int valid) {
  for (int idx = threadIdx.x; idx < kBk * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * stride + c] = r < valid ? to_f32(src[idx]) : 0.0f;
  }
}

__device__ inline float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int s,
                  int window, float scale, float softcap) {
  static_assert(kBq == kBk && D % 16 == 0, "tile shapes");
  constexpr int QS = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBq * QS;
  float* sv = sk + kBk * QS;
  float* sp = sv + kBk * D;

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long base = (long)blockIdx.y * s * D;
  const int q0 = blockIdx.x * kBq;
  const int q_rows = min(kBq, s - q0);
  stage<T, D>(sq, QS, q + base + (long)q0 * D, q_rows);

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int kv_first = max(0, q0 - window + 1) / kBk;
  const int kv_last = (q0 + q_rows - 1) / kBk;
  for (int t = kv_first; t <= kv_last; ++t) {
    const int k0 = t * kBk;
    const int k_rows = min(kBk, s - k0);
    __syncthreads();  // the previous tile's readers of sk, sv, sp are done
    stage<T, D>(sk, QS, k + base + (long)k0 * D, k_rows);
    stage<T, D>(sv, D, v + base + (long)k0 * D, k_rows);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = __fmul_rn(sc[i][j], scale);
        if (softcap != 0.0f)
          x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
        const bool keep = kp <= qp && kp > qp - window && kp < s;
        sc[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sp[(ty * 4 + i) * kPs + tx + 16 * j] = p;
        rs = __fadd_rn(rs, p);
      }
      l_i[i] = __fadd_rn(__fmul_rn(l_i[i], alpha), row_sum16(rs));
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      m_i[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * kPs + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = __fmaf_rn(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= s) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* dst = o + base + (long)qp * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dst + tx + 16 * c, __fdiv_rn(acc[i][c], l));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int window, float scale, float softcap,
                   cudaStream_t stream) {
  auto kern = local_attn_kernel<T, D>;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((s + kBq - 1) / kBq), (unsigned)bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, window, scale,
      softcap);
  return cudaGetLastError();
}


// ---- bf16 on the tensor cores -------------------------------------------

constexpr int kWG = 2;                   // consumer warpgroups, 64 rows each
constexpr int kBqT = 64 * kWG;           // query rows per block
constexpr int kStages = 2;               // K/V ring depth
constexpr int kTcThreads = 128 * (kWG + 1);
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, every tile 1024-byte aligned (the 128-byte
// swizzle's atom).  A tile of R rows and D columns is D/64 chunks of
// (R, 64) bf16, one TMA box each.
template <int D, int BK>
struct TcSmem {
  static constexpr int kQBytes = kBqT * D * 2;
  static constexpr int kKVBytes = BK * D * 2;   // one K or one V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
struct TcTile {
  static constexpr int kBk = D == 256 ? 64 : 128;
};

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// two bf16 as one 32-bit register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int D, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
local_attn_tc_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     __nv_bfloat16* __restrict__ o, int s, int window,
                     float scale, float softcap) {
  using L = TcSmem<D, BK>;
  constexpr int kChunks = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto* sq = reinterpret_cast<__nv_bfloat16*>(base);
  auto* sk = reinterpret_cast<__nv_bfloat16*>(base + L::kKOff);
  auto* sv = reinterpret_cast<__nv_bfloat16*>(base + L::kVOff);
  auto* q_bar = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  // the heaviest query tiles (the most kv tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBqT;
  const int bh = blockIdx.y;
  const int q_end = min(q0 + kBqT, s);
  const int kv_first = max(0, q0 - window + 1) / BK;
  const int kv_last = (q_end - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, kWG * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWG) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kWG * 128) {
      hopper::mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_load_3d(sq + c * kBqT * 64, &mq, q_bar, c * 64, q0, bh);
      for (int t = kv_first, i = 0; t <= kv_last; ++t, ++i) {
        const int st = i % kStages;
        hopper::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + st, 2 * L::kKVBytes);
        __nv_bfloat16* kt = sk + st * BK * D;
        __nv_bfloat16* vt = sv + st * BK * D;
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_3d(kt + c * BK * 64, &mk, full + st, c * 64,
                              t * BK, bh);
          hopper::tma_load_3d(vt + c * BK * 64, &mv, full + st, c * 64,
                              t * BK, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows r_lo .. r_lo + 63 ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int r_lo = q0 + wg * 64;
    const int row0 = r_lo + (tid / 32) * 16 + (tid % 32) / 4;  // and row0 + 8
    const int col0 = 2 * (tid % 4);
    const float scale_log2 = scale * kLog2e;
    const float cap_log2 = softcap * kLog2e;
    const float inv_cap = softcap != 0.0f ? 1.0f / softcap : 0.0f;

    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.0f, 0.0f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;

    hopper::mbar_wait(q_bar, 0);
    const __nv_bfloat16* sq_wg = sq + wg * 64 * 64;

    for (int t = kv_first, i = 0; t <= kv_last; ++t, ++i) {
      const int st = i % kStages;
      hopper::mbar_wait(full + st, (i / kStages) & 1);
      const int k0 = t * BK;
      const bool skip = k0 > r_lo + 63 || k0 + BK - 1 <= r_lo - window;
      if (!skip) {
        const __nv_bfloat16* kt = sk + st * BK * D;
        const __nv_bfloat16* vt = sv + st * BK * D;

        // S = Q K^T
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk % 4) * 16;   // 32 bytes a k16 step
          const uint64_t a = hopper::desc_sw128(
              sq_wg + (kk / 4) * kBqT * 64 + off, 16, 1024);
          const uint64_t b =
              hopper::desc_sw128(kt + (kk / 4) * BK * 64 + off, 16, 1024);
          hopper::wgmma_ss<BK>(sc, a, b, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);

        // scores in the log2 domain, masked where the tile crosses an edge
        const bool edge = k0 + BK - 1 > r_lo ||
                          k0 <= r_lo + 63 - window || k0 + BK > s;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * h + e];
              if (softcap != 0.0f)
                x = __fmul_rn(cap_log2,
                              tanhf(__fmul_rn(__fmul_rn(x, scale), inv_cap)));
              else
                x = __fmul_rn(x, scale_log2);
              if (edge) {
                const int qp = row0 + 8 * h;
                const int kp = k0 + 8 * j + col0 + e;
                if (!(kp <= qp && kp > qp - window && kp < s)) x = kNegInf;
              }
              sc[4 * j + 2 * h + e] = x;
              mx[h] = fmaxf(mx[h], x);
            }
        float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = quad_max(mx[h]);
          alpha[h] = exp2f(m_r[h] - mx[h]);
          m_r[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(sc[4 * j + 2 * h + e] - mx[h]);
              sc[4 * j + 2 * h + e] = p;
              rs[h] = __fadd_rn(rs[h], p);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          l_r[h] = __fadd_rn(__fmul_rn(l_r[h], alpha[h]), rs[h]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[4 * j + 2 * h + e] = __fmul_rn(acc[4 * j + 2 * h + e],
                                                 alpha[h]);

        // P as wgmma A fragments: the accumulator layout of S read as
        // k16 slices (rows r, r+8; columns c, c+1 and c+8, c+9)
        uint32_t p_hi[BK / 16][4];
        uint32_t p_lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
            const __nv_bfloat16 ha = __float2bfloat16_rn(a);
            const __nv_bfloat16 hb = __float2bfloat16_rn(b);
            p_hi[kk][r] = pack_bf16(ha, hb);
            p_lo[kk][r] = pack_bf16(
                __float2bfloat16_rn(__fsub_rn(a, __bfloat162float(ha))),
                __float2bfloat16_rn(__fsub_rn(b, __bfloat162float(hb))));
          }

        // O += P V
        hopper::fence_regs(acc);
        fence_u32(p_hi);
        fence_u32(p_lo);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t b =
              hopper::desc_sw128(vt + kk * 16 * 64, BK * 128, 1024);
          hopper::wgmma_rs<D>(acc, p_hi[kk], b);
          hopper::wgmma_rs<D>(acc, p_lo[kk], b);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(acc);
      }
      hopper::mbar_arrive(empty + st);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = row0 + 8 * h;
      const float l = fmaxf(quad_sum(l_r[h]), 1e-30f);
      if (qp >= s) continue;
      __nv_bfloat16* dst = o + ((long)bh * s + qp) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * h], l),
                                  __fdiv_rn(acc[4 * j + 2 * h + 1], l));
    }
  }
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// error codes past cudaError_t's range
constexpr int kErrEntryPoint = 10000;   // no cuTensorMapEncodeTiled
constexpr int kErrAlign = 10001;        // a pointer not 16-byte aligned
constexpr int kErrEncode = 20000;       // + the CUresult of the encode

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A (BH, S, D) bf16 tensor as boxes of (64 columns, rows rows, 1 head),
// 128-byte swizzle, rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
             int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return kErrEntryPoint;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return kErrAlign;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int bh,
              int s, int window, float scale, float softcap,
              cudaStream_t stream) {
  constexpr int BK = TcTile<D>::kBk;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, bh, s, D, kBqT);
  if (!err) err = make_map(&mk, k, bh, s, D, BK);
  if (!err) err = make_map(&mv, v, bh, s, D, BK);
  if (err) return err;
  auto kern = local_attn_tc_kernel<D, BK>;
  const int smem = TcSmem<D, BK>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((s + kBqT - 1) / kBqT), (unsigned)bh);
  kern<<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, window, scale, softcap);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int bh,
                int s, int d, int window, float scale, float softcap,
                cudaStream_t st) {
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, o, bh, s, window, scale, softcap, st);
    case 128:
      return launch_tc<128>(q, k, v, o, bh, s, window, scale, softcap, st);
    case 256:
      return launch_tc<256>(q, k, v, o, bh, s, window, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- f32, scalar ----------------------------------------------------------

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int s, int d, int window, float scale,
                     float softcap, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, bh, s, window, scale, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, s, window, scale, softcap, st);
    case 256:
      return launch<T, 256>(q, k, v, o, bh, s, window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o (bh, s, d) contiguous on the device, all f32 (is_bf16 = 0,
// the scalar kernel) or all bf16 (is_bf16 = 1, the tensor-core kernel);
// d in {64, 128, 256}; window >= 1.  Returns 0 once launched, else a
// cudaError_t or one of the kErr codes above (local_attn_error_string names
// it).
int local_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int bh, int s, int d, int window, float scale,
                      float softcap, int is_bf16, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (window < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_tc(q, k, v, o, bh, s, d, window, scale, softcap, st);
  return (int)dispatch<float>(q, k, v, o, bh, s, d, window, scale, softcap,
                              st);
}

const char* local_attn_error_string(int err) {
  static char buf[96];
  if (err == kErrEntryPoint)
    return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (err == kErrAlign)
    return "local_attn: q, k, v and out must be 16-byte aligned";
  if (err >= kErrEncode) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kErrEncode);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
