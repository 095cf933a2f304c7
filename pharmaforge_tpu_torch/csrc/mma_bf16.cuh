// bf16 tensor-core tile helpers for Hopper (sm_90a): one warp computes
// D[16x8] += A[16x16] * B[16x8] with `mma.sync.aligned.m16n8k16` (bf16
// inputs, fp32 accumulators), A loaded from a [row][column] bf16 tile in
// shared memory by `ldmatrix`, B from a fragment-ordered weight block.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16" with
// .bf16), lane = threadIdx.x % 32, g = lane / 4, t = lane % 4:
//   A: a[0] = (row g,     cols 2t, 2t+1)   a[1] = (row g + 8, cols 2t, 2t+1)
//      a[2] = (row g,     cols 2t+8, +9)   a[3] = (row g + 8, cols 2t+8, +9)
//   B: b.x  = (rows 2t, 2t+1 of column g)  b.y  = (rows 2t+8, 2t+9, col g)
//   D: d[0], d[1] = (row g, cols 2t, 2t+1)  d[2], d[3] = (row g + 8, same)
// Each 32-bit register holds two bf16 values, the lower index in the low
// half.
//
// Each helper has a PTX body for the card and a portable body, taken when
// __CUDA_ARCH__ is not defined, that computes the same fragments per lane
// from shared memory and warp shuffles. The portable bodies let a host
// compiler that runs each CUDA thread as a host thread check a kernel's
// arithmetic without a card (fp32 sums in a fixed order, so the last bits
// may differ from the tensor cores').

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace mma_bf16 {

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Element count of a [kd][n] weight block in fragment order: depth padded
// to 16, width to 8.
__host__ __device__ inline int frag_elems(int kd, int n) {
  return (kd + 15) / 16 * 16 * ((n + 7) / 8 * 8);
}

// Fragment order: for n-tile nt (8 columns) and k-tile kt (16 rows), the
// 32 lanes' B registers side by side, lane-major, so a warp reads one
// (nt, kt) fragment with one conflict-free 8-byte load a lane:
//   dst[((nt * KT + kt) * 32 + lane) * 4 + e] =
//       W[kt*16 + 2*(lane%4) + (e&1) + 8*(e>>1)][nt*8 + lane/4]
// with zeros beyond kd rows or n columns. `src` is [kd][n] row-major
// (stride n), of element type S (float or __nv_bfloat16).
template <typename S>
__device__ void stage_fragments(const S* __restrict__ src, int kd, int n, __nv_bfloat16* dst,
                                int tid, int nthreads) {
  const int KT = (kd + 15) / 16, NT = (n + 7) / 8;
  const int total = NT * KT * 128;
  constexpr int kBatch = 8;  // loads in flight per thread before the stores
  for (int i0 = tid; i0 < total; i0 += kBatch * nthreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nthreads;
      const int e = i & 3, lane = (i >> 2) & 31, tile = i >> 7;
      const int kt = tile % KT, nt = tile / KT;
      const int k = kt * 16 + 2 * (lane & 3) + (e & 1) + 8 * (e >> 1);
      const int c = nt * 8 + (lane >> 2);
      v[u] = i < total && k < kd && c < n ? as_float(src[k * n + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * nthreads < total) dst[i0 + u * nthreads] = __float2bfloat16_rn(v[u]);
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  uint16_t l, h;
  memcpy(&l, &lo, 2);
  memcpy(&h, &hi, 2);
  return static_cast<uint32_t>(l) | (static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float lo_f(uint32_t x) {
  const uint16_t h = static_cast<uint16_t>(x & 0xffffu);
  __nv_bfloat16 b;
  memcpy(&b, &h, 2);
  return __bfloat162float(b);
}
__device__ __forceinline__ float hi_f(uint32_t x) {
  const uint16_t h = static_cast<uint16_t>(x >> 16);
  __nv_bfloat16 b;
  memcpy(&b, &h, 2);
  return __bfloat162float(b);
}

// A fragment of the 16x16 tile whose top-left element is `tile` (shared
// memory, row stride `ld` elements; rows 16-byte aligned, ld a multiple of
// 8). On the card one `ldmatrix.x4`: lane l gives the address of row l%16,
// columns 8*(l/16) .. +7.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
#ifdef __CUDA_ARCH__
  const __nv_bfloat16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
#else
  const int g = lane >> 2, t = lane & 3;
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat16* p = tile + (g + 8 * (r & 1)) * ld + 2 * t + 8 * (r >> 1);
    a[r] = pack2(p[0], p[1]);
  }
#endif
}

// d += A * B for one 16x8 tile (fp32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
#else
  // gather rows g, g+8 of A and columns 2t, 2t+1 of B from the lanes that
  // hold them, then sum over k = 0..15 in order
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float arow[2][16], bcol[2][16];
  for (int q = 0; q < 4; ++q) {
    for (int r = 0; r < 4; ++r) {
      const uint32_t v = __shfl_sync(0xffffffffu, a[r], g * 4 + q);
      const int row = r & 1, k = 2 * q + 8 * (r >> 1);
      arow[row][k] = lo_f(v);
      arow[row][k + 1] = hi_f(v);
    }
    for (int j = 0; j < 2; ++j) {
      const uint32_t x = __shfl_sync(0xffffffffu, b.x, (2 * t + j) * 4 + q);
      const uint32_t y = __shfl_sync(0xffffffffu, b.y, (2 * t + j) * 4 + q);
      bcol[j][2 * q] = lo_f(x);
      bcol[j][2 * q + 1] = hi_f(x);
      bcol[j][2 * q + 8] = lo_f(y);
      bcol[j][2 * q + 9] = hi_f(y);
    }
  }
  for (int e = 0; e < 4; ++e) {
    float s = d[e];
    for (int k = 0; k < 16; ++k) s = fmaf(arow[e >> 1][k], bcol[e & 1][k], s);
    d[e] = s;
  }
#endif
}

}  // namespace mma_bf16
