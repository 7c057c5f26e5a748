// Banded dot-product similarity for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banded_sim.py::_banded_sim_kernel
// (reached through banded_sim_tiles' pl.pallas_call and the wrapper
// kernels/ops.py::banded_dot_band).  For each shard s, sorted row i and
// distance slot d in 0..window-1 (pair partner j = i + 1 + d):
//
//   out[s, i, d] = <feat_i, feat_j>        (raw dot, no clip; 0 where j >= m)
//
// feat is f32, or bf16 widened to f32 as it is staged; the dot accumulates
// in IEEE f32 FMAs.
//
// Bound: device-memory bytes.  Each input row is read once and each band
// row written once (S*M*F*elem + S*M*window*4 bytes), against 2F operations
// per pair, far under the f32 ridge.
//
// Design (the scheme of fused_band.cu): grid (row tiles, S), one thread per
// row.  A block stages its tile of `rows` rows plus the `window` successor
// rows in shared memory with coalesced loads, so every row is read from
// device memory about once.  Shared rows are padded to an odd word stride so
// the 32 threads of a warp, each reading its own row, hit 32 different
// banks.  The TPU kernel's (Bi, 2*Bi) MXU tile and the host gather of the
// band from it are not carried over: only the band is computed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int odd_stride(int n) { return (n % 2) ? n : n + 1; }

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void banded_sim_kernel(const T* __restrict__ feat,
                                  float* __restrict__ out, int m, int f,
                                  int window, int rows) {
  extern __shared__ float sfeat[];
  const int fs = odd_stride(f);
  const int tile_rows = rows + window;

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;

  const T* src = feat + ((long)s * m + row0) * f;
  const int n = have * f;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    sfeat[(idx / f) * fs + idx % f] = to_f32(src[idx]);
  __syncthreads();

  const int r = threadIdx.x;
  const long i = row0 + r;
  if (i >= m) return;
  float* o = out + ((long)s * m + i) * window;
  const float* a = sfeat + r * fs;

  for (int d = 0; d < window; ++d) {
    if (i + 1 + d >= m) {
      o[d] = 0.0f;
      continue;
    }
    const float* b = sfeat + (r + 1 + d) * fs;
    float dot = 0.0f;
    for (int k = 0; k < f; ++k) dot = __fmaf_rn(a[k], b[k], dot);
    o[d] = dot;
  }
}

template <typename T>
cudaError_t launch(const void* feat, void* out, int s, int m, int f,
                   int window, int rows, size_t smem, cudaStream_t stream) {
  auto kern = banded_sim_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  kern<<<grid, rows, smem, stream>>>(static_cast<const T*>(feat),
                                     static_cast<float*>(out), m, f, window,
                                     rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs (rows staged as f32).
size_t banded_sim_smem_bytes(int rows, int window, int f) {
  return ((size_t)rows + window) * odd_stride(f) * 4;
}

// feat (s, m, f) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), out (s, m, window)
// f32, both contiguous on the device.  Returns a cudaError_t (0 = launched).
int banded_sim_launch(const void* feat, void* out, int s, int m, int f,
                      int window, int rows, int is_bf16, void* stream) {
  if (s <= 0 || m <= 0) return 0;
  if (rows < 1 || rows > 1024 || window < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = banded_sim_smem_bytes(rows, window, f);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16>(feat, out, s, m, f, window, rows, smem, st)
      : launch<float>(feat, out, s, m, f, window, rows, smem, st));
}

const char* banded_sim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
