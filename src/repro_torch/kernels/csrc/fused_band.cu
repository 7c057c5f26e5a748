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
// ~2F + 4W operations per pair, so the kernel is far under the f32 ridge.
//
// Design: grid (row tiles, S), one thread per row.  A block stages its
// tile of `rows` rows plus the `window` successor rows of feat and sig in
// shared memory with coalesced loads, so every row is read from device
// memory about once (the successor overlap is window/rows extra).  Shared
// rows are padded to an odd word stride (F+1 or W+1 when F/W are even) so
// the 32 threads of a warp, each reading its own row, hit 32 different
// banks.  Each thread produces its row's `window` scores from shared
// memory with IEEE f32 FMAs for the dot and __popc for the Jaccard counts;
// the division is IEEE (built without fast math).  The TPU kernel's
// (Bi, 2*Bi) MXU tile is not carried over: only the band is computed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int odd_stride(int n) { return (n % 2) ? n : n + 1; }

template <bool kCos, bool kJac>
__global__ void fused_band_kernel(const float* __restrict__ feat,
                                  const int32_t* __restrict__ sig,
                                  float* __restrict__ out,
                                  int m, int f, int words, int window,
                                  int rows, float w_cos, float w_jac) {
  extern __shared__ unsigned char smem_raw[];
  const int fs = kCos ? odd_stride(f) : 0;
  const int ws = kJac ? odd_stride(words) : 0;
  const int tile_rows = rows + window;
  float* sfeat = reinterpret_cast<float*>(smem_raw);
  int32_t* ssig = reinterpret_cast<int32_t*>(sfeat + (size_t)tile_rows * fs);

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;

  if (kCos) {
    const float* src = feat + ((long)s * m + row0) * f;
    const int n = have * f;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
      sfeat[(idx / f) * fs + idx % f] = src[idx];
  }
  if (kJac) {
    const int32_t* src = sig + ((long)s * m + row0) * words;
    const int n = have * words;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
      ssig[(idx / words) * ws + idx % words] = src[idx];
  }
  __syncthreads();

  const int r = threadIdx.x;
  const long i = row0 + r;
  if (i >= m) return;
  float* o = out + ((long)s * m + i) * window;

  for (int d = 0; d < window; ++d) {
    const long j = i + 1 + d;
    if (j >= m) {
      o[d] = 0.0f;
      continue;
    }
    const int rj = r + 1 + d;
    float acc = 0.0f;
    if (kCos) {
      const float* a = sfeat + r * fs;
      const float* b = sfeat + rj * fs;
      float dot = 0.0f;
      for (int k = 0; k < f; ++k) dot = __fmaf_rn(a[k], b[k], dot);
      const float c = fminf(fmaxf(__fmul_rn(0.5f, __fadd_rn(dot, 1.0f)), 0.0f),
                            1.0f);
      acc = __fmul_rn(w_cos, c);
    }
    if (kJac) {
      const int32_t* a = ssig + r * ws;
      const int32_t* b = ssig + rj * ws;
      int inter = 0, uni = 0;
      for (int k = 0; k < words; ++k) {
        inter += __popc(a[k] & b[k]);
        uni += __popc(a[k] | b[k]);
      }
      const float jac = uni > 0
          ? __fdiv_rn((float)inter, fmaxf((float)uni, 1.0f)) : 1.0f;
      acc = __fadd_rn(acc, __fmul_rn(w_jac, jac));
    }
    o[d] = acc;
  }
}

template <bool kCos, bool kJac>
cudaError_t launch(const float* feat, const int32_t* sig, float* out, int s,
                   int m, int f, int words, int window, int rows,
                   float w_cos, float w_jac, size_t smem, cudaStream_t stream) {
  auto kern = fused_band_kernel<kCos, kJac>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  kern<<<grid, rows, smem, stream>>>(feat, sig, out, m, f, words, window,
                                     rows, w_cos, w_jac);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs.
size_t fused_band_smem_bytes(int rows, int window, int f, int words,
                             int use_cos, int use_jac) {
  const size_t tile = (size_t)rows + window;
  return tile * ((use_cos ? odd_stride(f) : 0) + (use_jac ? odd_stride(words) : 0))
      * 4;
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
    err = launch<true, true>(fp, sp, op, s, m, f, words, window, rows, w_cos,
                             w_jac, smem, st);
  else if (use_cos)
    err = launch<true, false>(fp, sp, op, s, m, f, words, window, rows, w_cos,
                              w_jac, smem, st);
  else if (use_jac)
    err = launch<false, true>(fp, sp, op, s, m, f, words, window, rows, w_cos,
                              w_jac, smem, st);
  else
    err = cudaMemsetAsync(out, 0, (size_t)s * m * window * sizeof(float), st);
  return (int)err;
}

const char* fused_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
