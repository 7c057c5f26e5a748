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
// in IEEE f32 FMAs over k = 0..F-1 in order, as fused_band.cu's cosine half
// does, so the two kernels' dots are equal bit for bit.
//
// Bound: device-memory bytes.  Each input row is read once and each band
// row written once (S*M*F*elem + S*M*window*4 bytes), against 2F operations
// per pair, far under the f32 ridge.
//
// Design (fused_band.cu's scheme, with its helpers from csrc/band.cuh):
// grid (row tiles, S), one thread per row, `rows` rows a block.
//   Loads.  The block's contiguous input span (the tile and its `window`
//     successor rows) goes into shared rows of stride 4 (mod 8) words by
//     16-byte cp.async where F is a multiple of 4 and the span 16-byte
//     aligned, else by element loads walking (row, column) with no
//     division; bf16 takes the element walk, widened to f32 as it lands.
//   Compute.  Each thread keeps its own row in registers (F <= 32, the
//     main path's width; wider rows are read from shared memory) and reads
//     each partner row as float4, which on that stride puts the 16-byte
//     reads of 8 threads on 8 consecutive rows on all 32 banks once.
//   Stores.  The scores go into a shared (rows, window) tile, written back
//     as the contiguous span out[s, row0 : row0 + rows, :] in 16-byte
//     stores with a scalar head and tail.
// The TPU kernel's (Bi, 2*Bi) MXU tile and the host gather of the band from
// it are not carried over: only the band is computed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"

namespace {

template <typename T, bool kReg>
__global__ void banded_sim_kernel(const T* __restrict__ feat,
                                  float* __restrict__ out, int m, int f,
                                  int window, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fs = band::vec_stride(f);
  const int tile_rows = rows + window;
  float* sfeat = reinterpret_cast<float*>(smem_raw);
  float* sout = sfeat + (size_t)tile_rows * fs;

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;
  const int out_rows = left < rows ? (int)left : rows;

  band::stage_rows(sfeat, fs, feat + ((long)s * m + row0) * f, have, f);
  float* dst = out + ((long)s * m + row0) * window;
  const int head = band::store_head(dst);
  float* tile = sout + ((4 - head) & 3);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < out_rows) {
    const long i = row0 + r;
    float a[kReg ? band::kRegF : 1];
    if (kReg) band::row_to_regs(a, sfeat + r * fs, f);
    float* o = tile + r * window;
    // three slots at a time: three independent FMA chains in flight
#pragma unroll 3
    for (int d = 0; d < window; ++d)
      o[d] = i + 1 + d < m
          ? band::dot_row<kReg>(a, sfeat + r * fs, sfeat + (r + 1 + d) * fs,
                                f)
          : 0.0f;
  }
  __syncthreads();
  band::store_tile(dst, tile, out_rows * window, head);
}

template <typename T, bool kReg>
cudaError_t launch(const void* feat, void* out, int s, int m, int f,
                   int window, int rows, size_t smem, cudaStream_t stream) {
  auto kern = banded_sim_kernel<T, kReg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  kern<<<grid, rows, smem, stream>>>(static_cast<const T*>(feat),
                                     static_cast<float*>(out), m, f, window,
                                     rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_widths(const void* feat, void* out, int s, int m, int f,
                          int window, int rows, size_t smem,
                          cudaStream_t st) {
  return f <= band::kRegF
      ? launch<T, true>(feat, out, s, m, f, window, rows, smem, st)
      : launch<T, false>(feat, out, s, m, f, window, rows, smem, st);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs: the input tile
// (rows + window rows, staged as f32) and the (rows, window) output tile
// with its alignment slack.
size_t banded_sim_smem_bytes(int rows, int window, int f) {
  return (((size_t)rows + window) * band::vec_stride(f) +
          (size_t)rows * window + 4) * 4;
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
      ? launch_widths<__nv_bfloat16>(feat, out, s, m, f, window, rows, smem,
                                     st)
      : launch_widths<float>(feat, out, s, m, f, window, rows, smem, st));
}

const char* banded_sim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
