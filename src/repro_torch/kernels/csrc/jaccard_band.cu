// Banded Jaccard over bit-packed signatures for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jaccard_band.py::_jaccard_kernel
// (reached through jaccard_band_tiles' pl.pallas_call and the wrapper
// kernels/ops.py::jaccard_band).  For each shard s, sorted row i and
// distance slot d in 0..window-1 (pair partner j = i + 1 + d):
//
//   out[s, i, d] = sum popc(a & b) / max(sum popc(a | b), 1)   (0 where j >= m)
//
// over the signature words (int32 bit views of the reference's uint32).
// Empty vs empty is 0.0 (the IEEE division 0 / 1), as in the reference
// kernel and unlike fused_band.cu's Jaccard half (1.0).
//
// Bound: device-memory bytes.  Each signature row is read once and each band
// row written once (S*M*W*4 + S*M*window*4 bytes), against ~4W integer
// operations per pair.
//
// Design (the scheme of fused_band.cu): grid (row tiles, S), one thread per
// row; the tile of `rows` rows plus the `window` successor rows is staged in
// shared memory with coalesced loads, rows padded to an odd word stride so a
// warp's 32 rows fall in 32 different banks.  __popc on the int32 words; the
// division is IEEE (built without fast math).  The TPU kernel's (Bi, 2*Bi)
// tile is not carried over: only the band is computed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int odd_stride(int n) { return (n % 2) ? n : n + 1; }

__global__ void jaccard_band_kernel(const int32_t* __restrict__ sig,
                                    float* __restrict__ out, int m, int words,
                                    int window, int rows) {
  extern __shared__ int32_t ssig[];
  const int ws = odd_stride(words);
  const int tile_rows = rows + window;

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;

  const int32_t* src = sig + ((long)s * m + row0) * words;
  const int n = have * words;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    ssig[(idx / words) * ws + idx % words] = src[idx];
  __syncthreads();

  const int r = threadIdx.x;
  const long i = row0 + r;
  if (i >= m) return;
  float* o = out + ((long)s * m + i) * window;
  const int32_t* a = ssig + r * ws;

  for (int d = 0; d < window; ++d) {
    if (i + 1 + d >= m) {
      o[d] = 0.0f;
      continue;
    }
    const int32_t* b = ssig + (r + 1 + d) * ws;
    int inter = 0, uni = 0;
    for (int k = 0; k < words; ++k) {
      inter += __popc(a[k] & b[k]);
      uni += __popc(a[k] | b[k]);
    }
    o[d] = __fdiv_rn((float)inter, fmaxf((float)uni, 1.0f));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs.
size_t jaccard_band_smem_bytes(int rows, int window, int words) {
  return ((size_t)rows + window) * odd_stride(words) * 4;
}

// sig (s, m, words) int32, out (s, m, window) f32, both contiguous on the
// device.  Returns a cudaError_t (0 = launched).
int jaccard_band_launch(const void* sig, void* out, int s, int m, int words,
                        int window, int rows, void* stream) {
  if (s <= 0 || m <= 0) return 0;
  if (rows < 1 || rows > 1024 || window < 1 || words < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = jaccard_band_smem_bytes(rows, window, words);
  cudaError_t err = cudaFuncSetAttribute(
      jaccard_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  jaccard_band_kernel<<<grid, rows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sig), static_cast<float*>(out), m, words,
      window, rows);
  return (int)cudaGetLastError();
}

const char* jaccard_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
