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
// The staging, register, dot and store helpers are csrc/band.cuh's, shared
// with banded_sim.cu and jaccard_band.cu.  The TPU kernel's (Bi, 2*Bi) MXU
// tile is not carried over: only the band is computed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"

namespace {

using band::kRegF;
using band::kRegW;

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

template <bool kCos, bool kJac, bool kReg>
__global__ void fused_band_kernel(const float* __restrict__ feat,
                                  const int32_t* __restrict__ sig,
                                  float* __restrict__ out,
                                  int m, int f, int words, int window,
                                  int rows, float w_cos, float w_jac) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fs = kCos ? band::vec_stride(f) : 0;
  const int ws = kJac ? band::vec_stride(words) : 0;
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
    band::stage_rows(sfeat, fs, feat + ((long)s * m + row0) * f, have, f);
  if (kJac)
    band::stage_rows(ssig, ws, sig + ((long)s * m + row0) * words, have,
                     words);

  // element e of the output span sits at tile[e], tile + head 16-byte
  // aligned
  float* dst = out + ((long)s * m + row0) * window;
  const int head = band::store_head(dst);
  float* tile = sout + ((4 - head) & 3);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < out_rows) {
    const long i = row0 + r;
    float a_feat[kReg && kCos ? kRegF : 1];
    int32_t a_sig[kReg && kJac ? kRegW : 1];
    if (kReg && kCos) band::row_to_regs(a_feat, sfeat + r * fs, f);
    if (kReg && kJac) band::row_to_regs(a_sig, ssig + r * ws, words);
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
        const float dot = band::dot_row<kReg>(a_feat, sfeat + r * fs,
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
  band::store_tile(dst, tile, out_rows * window, head);
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
  return (tile * ((use_cos ? band::vec_stride(f) : 0) +
                  (use_jac ? band::vec_stride(words) : 0)) +
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
