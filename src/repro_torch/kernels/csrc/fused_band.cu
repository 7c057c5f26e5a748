// Fused cheap-cascade band (cosine + bit-packed Jaccard) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_band.py::_fused_band_kernel
// (reached through fused_band_scores' pl.pallas_call and the wrapper
// kernels/ops.py::fused_cheap_band).  For each shard s, sorted row i and
// distance slot d in 0..window-1 (pair partner j = i + 1 + d):
//
//   out[s, i, d] = w_cos * clip(0.5 * (<feat_i, feat_j> + 1), 0, 1)
//                + w_jac * J(sig_i, sig_j)          (0 where j >= m)
//
// with J = sum popc(a & b) / sum popc(a | b) over the signature words and
// J(empty, empty) = 1.0.  A zero weight disables its half; that half's
// input is then an (S, M, 1) dummy which is never read.
//
// Bound: device-memory bytes.  Each input row is read once and each band
// row written once (S*M*(F+W)*4 + S*M*window*4 bytes), against only
// ~2F + 6W operations per pair, so the kernel is far under the f32 ridge.
//
// Design: grid (row tiles, S), one thread per row, `rows` rows a block.
//   Loads.  The block's input span feat[s, row0 : row0 + rows + window, :]
//     (the tile and its `window` successor rows) is contiguous; it is
//     copied into shared memory with 16-byte cp.async where the row width
//     is a multiple of 4 words and the span 16-byte aligned, else with
//     4-byte loads, walking (row, column) without a division per element.
//     Shared rows have a stride of 4 (mod 8) words, 16-byte aligned, so
//     the 16-byte reads of 8 threads on 8 consecutive rows hit all 32
//     banks once.
//   Compute.  Each thread keeps its own row in registers (F <= 32 and
//     W <= 8, the main path's widths; wider rows are read from shared
//     memory) and reads each partner row with 16-byte loads: IEEE f32 FMAs
//     over k in order for the dot, __popc for the Jaccard counts, IEEE
//     division (built without fast math).
//   Stores.  Each thread writes its `window` scores into a (rows, window)
//     tile in shared memory; after __syncthreads the block writes the tile,
//     which is the contiguous span out[s, row0 : row0 + rows, :], as 16-byte
//     stores by consecutive threads on consecutive addresses, with a scalar
//     head and tail where the span is not 16-byte aligned.  (One thread
//     storing its own row's scores would put the 32 lanes of a store
//     window*4 bytes apart.)
// The TPU kernel's (Bi, 2*Bi) MXU tile is not carried over: only the band
// is computed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegF = 32;   // feature words a thread keeps in registers
constexpr int kRegW = 8;    // signature words a thread keeps in registers

// Row stride in words: 16-byte aligned, and 4 (mod 8) against bank
// conflicts of 16-byte reads.
__host__ __device__ inline int vec_stride(int n) {
  const int s = (n + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Rows [0, nrows) of width `width` words from the contiguous span `src`
// into `dst` at row stride `stride`.
template <typename T>
__device__ inline void stage_rows(T* dst, int stride, const T* src,
                                  int nrows, int width) {
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int w4 = width / 4;
    const int n4 = nrows * w4;
    int r = threadIdx.x / w4, c = threadIdx.x % w4 * 4;
    const int dr = blockDim.x / w4, dc = blockDim.x % w4 * 4;
    for (int v = threadIdx.x; v < n4; v += blockDim.x) {
      cp_async16(dst + r * stride + c, src + 4 * v);
      c += dc;
      r += dr;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    const int n = nrows * width;
    int r = threadIdx.x / width, c = threadIdx.x % width;
    const int dr = blockDim.x / width, dc = blockDim.x % width;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      dst[r * stride + c] = src[idx];
      c += dc;
      r += dr;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
  }
}

// <a, b> over k = 0..f-1 in order, b a 16-byte aligned shared row.
template <bool kReg>
__device__ inline float dot_row(const float* a_reg, const float* a_smem,
                                const float* b, int f) {
  float dot = 0.0f;
  if (kReg) {
#pragma unroll
    for (int q = 0; q < kRegF / 4; ++q) {
      if (4 * q >= f) break;
      const float4 v = *reinterpret_cast<const float4*>(b + 4 * q);
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < f) dot = __fmaf_rn(a_reg[4 * q + e], bv[e], dot);
    }
  } else {
    for (int q = 0; 4 * q < f; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(a_smem + 4 * q);
      const float4 v = *reinterpret_cast<const float4*>(b + 4 * q);
      const float av[4] = {u.x, u.y, u.z, u.w};
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < f) dot = __fmaf_rn(av[e], bv[e], dot);
    }
  }
  return dot;
}

template <bool kReg>
__device__ inline void popc_row(const int32_t* a_reg, const int32_t* a_smem,
                                const int32_t* b, int words, int& inter,
                                int& uni) {
  inter = 0;
  uni = 0;
  if (kReg) {
#pragma unroll
    for (int q = 0; q < kRegW / 4; ++q) {
      if (4 * q >= words) break;
      const int4 v = *reinterpret_cast<const int4*>(b + 4 * q);
      const int32_t bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < words) {
          inter += __popc(a_reg[4 * q + e] & bv[e]);
          uni += __popc(a_reg[4 * q + e] | bv[e]);
        }
    }
  } else {
    for (int q = 0; 4 * q < words; ++q) {
      const int4 u = *reinterpret_cast<const int4*>(a_smem + 4 * q);
      const int4 v = *reinterpret_cast<const int4*>(b + 4 * q);
      const int32_t av[4] = {u.x, u.y, u.z, u.w};
      const int32_t bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < words) {
          inter += __popc(av[e] & bv[e]);
          uni += __popc(av[e] | bv[e]);
        }
    }
  }
}

// The contiguous span dst[0, n) from `tile`, where tile + head is 16-byte
// aligned (head = the floats before dst's first 16-byte boundary).
__device__ inline void store_tile(float* dst, const float* tile, int n,
                                  int head) {
  head = min(head, n);
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = tile[e];
  const int n4 = (n - head) / 4;
  auto* d4 = reinterpret_cast<float4*>(dst + head);
  auto* t4 = reinterpret_cast<const float4*>(tile + head);
  for (int v = threadIdx.x; v < n4; v += blockDim.x) d4[v] = t4[v];
  for (int e = head + 4 * n4 + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = tile[e];
}

template <bool kCos, bool kJac, bool kReg>
__global__ void fused_band_kernel(const float* __restrict__ feat,
                                  const int32_t* __restrict__ sig,
                                  float* __restrict__ out,
                                  int m, int f, int words, int window,
                                  int rows, float w_cos, float w_jac) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fs = kCos ? vec_stride(f) : 0;
  const int ws = kJac ? vec_stride(words) : 0;
  const int tile_rows = rows + window;
  float* sfeat = reinterpret_cast<float*>(smem_raw);
  int32_t* ssig = reinterpret_cast<int32_t*>(sfeat + (size_t)tile_rows * fs);
  float* sout = reinterpret_cast<float*>(ssig + (size_t)tile_rows * ws);

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;
  const int out_rows = left < rows ? (int)left : rows;

  if (kCos)
    stage_rows(sfeat, fs, feat + ((long)s * m + row0) * f, have, f);
  if (kJac)
    stage_rows(ssig, ws, sig + ((long)s * m + row0) * words, have, words);

  // element e of the output span sits at tile[e], tile + head 16-byte
  // aligned
  float* dst = out + ((long)s * m + row0) * window;
  const int head =
      (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4;
  float* tile = sout + ((4 - head) & 3);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < out_rows) {
    const long i = row0 + r;
    float a_feat[kReg && kCos ? kRegF : 1];
    int32_t a_sig[kReg && kJac ? kRegW : 1];
    if (kReg && kCos) {
#pragma unroll
      for (int q = 0; q < kRegF / 4; ++q) {
        if (4 * q >= f) break;
        const float4 v = *reinterpret_cast<const float4*>(sfeat + r * fs +
                                                          4 * q);
        a_feat[4 * q] = v.x;
        a_feat[4 * q + 1] = v.y;
        a_feat[4 * q + 2] = v.z;
        a_feat[4 * q + 3] = v.w;
      }
    }
    if (kReg && kJac) {
#pragma unroll
      for (int q = 0; q < kRegW / 4; ++q) {
        if (4 * q >= words) break;
        const int4 v = *reinterpret_cast<const int4*>(ssig + r * ws + 4 * q);
        a_sig[4 * q] = v.x;
        a_sig[4 * q + 1] = v.y;
        a_sig[4 * q + 2] = v.z;
        a_sig[4 * q + 3] = v.w;
      }
    }
    float* o = tile + r * window;
    // three slots at a time: three independent FMA chains in flight
#pragma unroll 3
    for (int d = 0; d < window; ++d) {
      const long j = i + 1 + d;
      if (j >= m) {
        o[d] = 0.0f;
        continue;
      }
      const int rj = r + 1 + d;
      float acc = 0.0f;
      if (kCos) {
        const float dot = dot_row<kReg>(a_feat, sfeat + r * fs,
                                        sfeat + rj * fs, f);
        const float c = fminf(fmaxf(__fmul_rn(0.5f, __fadd_rn(dot, 1.0f)), 0.0f),
                              1.0f);
        acc = __fmul_rn(w_cos, c);
      }
      if (kJac) {
        int inter, uni;
        popc_row<kReg>(a_sig, ssig + r * ws, ssig + rj * ws, words, inter,
                       uni);
        const float jac = uni > 0
            ? __fdiv_rn((float)inter, fmaxf((float)uni, 1.0f)) : 1.0f;
        acc = __fadd_rn(acc, __fmul_rn(w_jac, jac));
      }
      o[d] = acc;
    }
  }
  __syncthreads();
  store_tile(dst, tile, out_rows * window, head);
}


template <bool kCos, bool kJac, bool kReg>
cudaError_t launch(const float* feat, const int32_t* sig, float* out, int s,
                   int m, int f, int words, int window, int rows,
                   float w_cos, float w_jac, size_t smem, cudaStream_t stream) {
  auto kern = fused_band_kernel<kCos, kJac, kReg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  kern<<<grid, rows, smem, stream>>>(feat, sig, out, m, f, words, window,
                                     rows, w_cos, w_jac);
  return cudaGetLastError();
}

template <bool kCos, bool kJac>
cudaError_t launch_widths(const float* feat, const int32_t* sig, float* out,
                          int s, int m, int f, int words, int window,
                          int rows, float w_cos, float w_jac, size_t smem,
                          cudaStream_t st) {
  const bool reg = (!kCos || f <= kRegF) && (!kJac || words <= kRegW);
  return reg ? launch<kCos, kJac, true>(feat, sig, out, s, m, f, words,
                                        window, rows, w_cos, w_jac, smem, st)
             : launch<kCos, kJac, false>(feat, sig, out, s, m, f, words,
                                         window, rows, w_cos, w_jac, smem,
                                         st);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs: the input tile
// (rows + window rows of each half in use) and the (rows, window) output
// tile with its alignment slack.
size_t fused_band_smem_bytes(int rows, int window, int f, int words,
                             int use_cos, int use_jac) {
  const size_t tile = (size_t)rows + window;
  return (tile * ((use_cos ? vec_stride(f) : 0) +
                  (use_jac ? vec_stride(words) : 0)) +
          (size_t)rows * window + 4) * 4;
}

// feat (s, m, f) f32, sig (s, m, words) int32, out (s, m, window) f32, all
// contiguous on the device.  Returns a cudaError_t (0 = launched).
int fused_band_launch(const void* feat, const void* sig, void* out, int s,
                      int m, int f, int words, int window, int rows,
                      float w_cos, float w_jac, int use_cos, int use_jac,
                      void* stream) {
  if (s <= 0 || m <= 0) return 0;
  if (rows < 1 || rows > 1024 || window < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_band_smem_bytes(rows, window, f, words, use_cos,
                                            use_jac);
  auto* fp = static_cast<const float*>(feat);
  auto* sp = static_cast<const int32_t*>(sig);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_cos && use_jac)
    err = launch_widths<true, true>(fp, sp, op, s, m, f, words, window, rows,
                                    w_cos, w_jac, smem, st);
  else if (use_cos)
    err = launch_widths<true, false>(fp, sp, op, s, m, f, words, window, rows,
                                     w_cos, w_jac, smem, st);
  else if (use_jac)
    err = launch_widths<false, true>(fp, sp, op, s, m, f, words, window, rows,
                                     w_cos, w_jac, smem, st);
  else
    err = cudaMemsetAsync(out, 0, (size_t)s * m * window * sizeof(float), st);
  return (int)err;
}

const char* fused_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
