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
// row written once (S*M*W*4 + S*M*window*4 bytes), against ~3W integer
// operations per pair.  Integer popcount issues at a quarter of the f32
// rate, so two popcounts a word-pair would take longer than the bytes at
// the main shape; inclusion-exclusion needs one:
//
//   sum popc(a | b) = P(a) + P(b) - sum popc(a & b),  P(x) = sum popc(x),
//
// with P taken once a staged row.  At 8 words (the main path's width) the
// 8 words of a row, or of a & b, are first added bit by bit in a
// carry-save tree of LOP3s into ones + 2 twos + 4 fours + 8 eights, so a
// pair takes 4 popcounts, not 8 (7% faster on the H100).  The counts are
// integers, so the result is the two-popcount one bit for bit; the
// division is IEEE (built without fast math).
//
// Design (fused_band.cu's scheme, with its helpers from csrc/band.cuh):
// grid (row tiles, S), one thread per row, `rows` rows a block.  The
// block's contiguous input span (the tile and its `window` successor rows)
// goes into shared rows of stride 4 (mod 8) words by 16-byte cp.async where
// W is a multiple of 4 and the span 16-byte aligned, else by 4-byte loads
// walking (row, column) with no division; then each staged row's P into one
// int a row.  Each thread keeps its own row in registers (W <= 8, the main
// path's width; wider rows are read from shared memory) and reads each
// partner row as int4.  The scores go into a shared (rows, window) tile,
// written back as the contiguous span out[s, row0 : row0 + rows, :] in
// 16-byte stores with a scalar head and tail.  The TPU kernel's (Bi, 2*Bi)
// tile is not carried over: only the band is computed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"

namespace {

// a + b + c = 2 * hi + lo, bit by bit (two LOP3s)
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// sum popc(x[k]) over 8 words with 4 popcounts: the words are added bit
// by bit in a carry-save tree into ones + 2 twos + 4 fours + 8 eights
__device__ __forceinline__ int popc8(const uint32_t (&x)[8]) {
  uint32_t t0, o0, t1, o1, t2, o2, f0, w0;
  csa(t0, o0, x[0], x[1], x[2]);
  csa(t1, o1, o0, x[3], x[4]);
  csa(t2, o2, o1, x[5], x[6]);
  const uint32_t ones = o2 ^ x[7], t3 = o2 & x[7];
  csa(f0, w0, t0, t1, t2);
  const uint32_t twos = w0 ^ t3, f1 = w0 & t3;
  return __popc(ones) + 2 * __popc(twos) + 4 * __popc(f0 ^ f1) +
         8 * __popc(f0 & f1);
}

// sum popc(a[k] & b[k]) over 8 words (popc8), a in registers and b a
// 16-byte aligned shared row
__device__ __forceinline__ int popc8_and(const int32_t* a, const int32_t* b) {
  const int4 u = *reinterpret_cast<const int4*>(b);
  const int4 v = *reinterpret_cast<const int4*>(b + 4);
  const uint32_t x[8] = {
      (uint32_t)(a[0] & u.x), (uint32_t)(a[1] & u.y), (uint32_t)(a[2] & u.z),
      (uint32_t)(a[3] & u.w), (uint32_t)(a[4] & v.x), (uint32_t)(a[5] & v.y),
      (uint32_t)(a[6] & v.z), (uint32_t)(a[7] & v.w)};
  return popc8(x);
}

// sum popc(a & b) over the words, b a 16-byte aligned shared row; a in
// registers (kReg, words <= kRegW) or the shared row a_smem.
template <bool kReg>
__device__ inline int popc_and(const int32_t* a_reg, const int32_t* a_smem,
                               const int32_t* b, int words) {
  int inter = 0;
  if (kReg && words == 8) return popc8_and(a_reg, b);
  if (kReg) {
#pragma unroll
    for (int q = 0; q < band::kRegW / 4; ++q) {
      if (4 * q >= words) break;
      const int4 v = *reinterpret_cast<const int4*>(b + 4 * q);
      const int32_t bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < words) inter += __popc(a_reg[4 * q + e] & bv[e]);
    }
  } else {
    for (int q = 0; 4 * q < words; ++q) {
      const int4 u = *reinterpret_cast<const int4*>(a_smem + 4 * q);
      const int4 v = *reinterpret_cast<const int4*>(b + 4 * q);
      const int32_t av[4] = {u.x, u.y, u.z, u.w};
      const int32_t bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < words) inter += __popc(av[e] & bv[e]);
    }
  }
  return inter;
}

// (rows + window) staged rows of ws words, then one popcount a row, then
// the (rows, window) output tile with 4 floats of alignment slack.
__host__ __device__ inline size_t pop_offset(int tile_rows, int ws) {
  return (size_t)tile_rows * ws;
}

__host__ __device__ inline size_t out_offset(int tile_rows, int ws) {
  return pop_offset(tile_rows, ws) + ((size_t)tile_rows + 3) / 4 * 4;
}

template <bool kReg>
__global__ void jaccard_band_kernel(const int32_t* __restrict__ sig,
                                    float* __restrict__ out, int m, int words,
                                    int window, int rows) {
  extern __shared__ __align__(16) int32_t smem[];
  const int ws = band::vec_stride(words);
  const int tile_rows = rows + window;
  int32_t* ssig = smem;
  int32_t* spop = smem + pop_offset(tile_rows, ws);
  float* sout = reinterpret_cast<float*>(smem + out_offset(tile_rows, ws));

  const int s = blockIdx.y;
  const long row0 = (long)blockIdx.x * rows;
  const long left = (long)m - row0;
  const int have = left < tile_rows ? (int)left : tile_rows;
  const int out_rows = left < rows ? (int)left : rows;

  band::stage_rows(ssig, ws, sig + ((long)s * m + row0) * words, have,
                   words);
  float* dst = out + ((long)s * m + row0) * window;
  const int head = band::store_head(dst);
  float* tile = sout + ((4 - head) & 3);
  __syncthreads();

  const int32_t all_ones[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  for (int t = threadIdx.x; t < have; t += blockDim.x) {
    if (words == 8) {
      spop[t] = popc8_and(all_ones, ssig + t * ws);
      continue;
    }
    int p = 0;
    for (int q = 0; 4 * q < words; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(ssig + t * ws + 4 * q);
      const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < words) p += __popc(w[e]);
    }
    spop[t] = p;
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < out_rows) {
    const long i = row0 + r;
    int32_t a[kReg ? band::kRegW : 1];
    if (kReg) band::row_to_regs(a, ssig + r * ws, words);
    const int pa = spop[r];
    float* o = tile + r * window;
#pragma unroll 3
    for (int d = 0; d < window; ++d) {
      const int rj = r + 1 + d;
      if (i + 1 + d >= m) {
        o[d] = 0.0f;
        continue;
      }
      const int inter = popc_and<kReg>(a, ssig + r * ws, ssig + rj * ws,
                                       words);
      const int uni = pa + spop[rj] - inter;
      o[d] = __fdiv_rn((float)inter, fmaxf((float)uni, 1.0f));
    }
  }
  __syncthreads();
  band::store_tile(dst, tile, out_rows * window, head);
}

template <bool kReg>
cudaError_t launch(const void* sig, void* out, int s, int m, int words,
                   int window, int rows, size_t smem, cudaStream_t stream) {
  auto kern = jaccard_band_kernel<kReg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + rows - 1) / rows), (unsigned)s);
  kern<<<grid, rows, smem, stream>>>(static_cast<const int32_t*>(sig),
                                     static_cast<float*>(out), m, words,
                                     window, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `rows` rows needs: the input tile
// (rows + window rows), one popcount a staged row, and the (rows, window)
// output tile with its alignment slack.
size_t jaccard_band_smem_bytes(int rows, int window, int words) {
  const int tile_rows = rows + window;
  return (out_offset(tile_rows, band::vec_stride(words)) +
          (size_t)rows * window + 4) * 4;
}

// sig (s, m, words) int32, out (s, m, window) f32, both contiguous on the
// device.  Returns a cudaError_t (0 = launched).
int jaccard_band_launch(const void* sig, void* out, int s, int m, int words,
                        int window, int rows, void* stream) {
  if (s <= 0 || m <= 0) return 0;
  if (rows < 1 || rows > 1024 || window < 1 || words < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = jaccard_band_smem_bytes(rows, window, words);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(words <= band::kRegW
      ? launch<true>(sig, out, s, m, words, window, rows, smem, st)
      : launch<false>(sig, out, s, m, words, window, rows, smem, st));
}

const char* jaccard_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
