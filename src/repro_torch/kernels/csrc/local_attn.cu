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
// as on the TPU.
//
// Bound: operations.  4*D per kept (query, key) pair, against 2 reads of
// each input and one write of the output; at D = 128 that is ~170 operations
// per byte, far over the ridge.  This kernel is scalar f32 (no tensor-core
// MMA), so it runs against the f32 rate: a first version that is right.
//
// Design: grid (query tiles of kBq rows, BH), kThreads threads per block.  A
// block stages its query tile once, then walks only the kv tiles of kBk keys
// that intersect [q0 - window + 1, q0 + kBq): about window/kBk + 1 tiles, not
// S/kBk.  Each kv tile is staged in shared memory (f32, widened from bf16).
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3: it
// computes the 4 x 4 scores of those rows against keys tx + 16*j in
// registers, reduces row max and row sum over its 16 lanes with shuffles,
// writes the probabilities to a shared P tile, and accumulates P @ V into
// its 4 x D/16 slice of acc (columns tx + 16*c) in registers.  Q and K rows
// are padded to an odd stride (D + 1) so the column-wise reads of 16
// different rows hit 16 different banks.  Shared memory: ~66 KB at D = 64,
// ~113 KB at D = 128, ~209 KB at D = 256 (of 227 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 query rows each
constexpr int kPs = kBk + 1;   // P tile stride
constexpr float kNegInf = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// q, k, v, o (bh, s, d) contiguous on the device, all f32 (is_bf16 = 0) or
// all bf16 (is_bf16 = 1); d in {64, 128, 256}; window >= 1.  Returns a
// cudaError_t (0 = launched).
int local_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int bh, int s, int d, int window, float scale,
                      float softcap, int is_bf16, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (window < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? dispatch<__nv_bfloat16>(q, k, v, o, bh, s, d, window, scale, softcap,
                                st)
      : dispatch<float>(q, k, v, o, bh, s, d, window, scale, softcap, st));
}

const char* local_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
