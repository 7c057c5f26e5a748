// Staging and store helpers shared by the three band kernels
// (fused_band.cu, banded_sim.cu, jaccard_band.cu).  Header-only.
//
// The scheme they serve: a block of `rows` threads, one a row, stages its
// contiguous input span (the tile and its `window` successor rows) into
// shared rows of stride vec_stride(width), computes each row's `window`
// scores into a shared (rows, window) tile, and writes the tile back as the
// contiguous span out[s, row0 : row0 + rows, :] with store_tile.
#pragma once

#include <stdint.h>

#include <type_traits>

namespace band {

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

// Rows [0, nrows) of width `width` elements from the contiguous span `src`
// into `dst` at row stride `stride`.  16-byte cp.async where T and S are
// one 4-byte type, the width a multiple of 4 and the span 16-byte aligned;
// else element loads (converted from S to T), walking (row, column) with no
// division per element.
template <typename T, typename S>
__device__ inline void stage_rows(T* dst, int stride, const S* src,
                                  int nrows, int width) {
  if (sizeof(T) == 4 && sizeof(S) == 4 && width % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
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
      dst[r * stride + c] = static_cast<T>(src[idx]);
      c += dc;
      r += dr;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
  }
}

// The first min(n, kN) elements of a 16-byte aligned shared row into
// registers (T a 4-byte type).
template <int kN, typename T>
__device__ inline void row_to_regs(T (&a)[kN], const T* row, int n) {
  using V = typename std::conditional<std::is_same<T, float>::value, float4,
                                      int4>::type;
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    if (4 * q >= n) break;
    const V v = *reinterpret_cast<const V*>(row + 4 * q);
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
}

// <a, b> over k = 0..f-1 in order, b a 16-byte aligned shared row; a in
// registers (kReg, f <= kRegF) or the shared row a_smem.
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

// The floats before dst's first 16-byte boundary.  A block puts element 0
// of its output tile at sout + ((4 - head) & 3), sout 16-byte aligned with
// 4 floats of slack, so that tile + head is aligned as dst + head is.
__device__ inline int store_head(const float* dst) {
  return (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4;
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

}  // namespace band
