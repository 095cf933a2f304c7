// Backward of the fused prot-prot message chain + masked K-sum (K3).
//
// Replaces the Pallas TPU kernel pharmaforge_tpu/ops/pallas/pp_message.py
// (`_bwd_kernel`, launched by `_pallas_bwd_impl`). Given K2's inputs (the
// per-copy node tables tab_s [B,P,S] and tab_v [B,P,3,H0], the group-level
// edge descriptors idx/mask [G,Nd,K], the edge terms rterm [G,Nd,K,S] and
// dirterm [G,Nd,K,3,H0], the raw geometry rbf [G,Nd,K,R] and x_dir
// [G,Nd,K,3], the packed chain weights) and the cotangents of K2's outputs
// ds [B,Nd,S] and dv [B,Nd,V,3] (fp32), it returns
//   d_tab_s [B,P,S] and d_tab_v [B,P,3,H0] (fp32, scattered to the source
//   atoms of every valid edge), and
//   every weight gradient of the chain (fp64, in the `split_weights` order
//   of ops/pp_message.py: GVP 0's wh0, wu, w1_d, w1_sh, b1, wg, bg, then each
//   later GVP's wh, wu, w1f, w1sh, b1, wg, bg, each [in, out] row-major, no
//   padding). GVP 0's w1_d, b1 and wh0 enter K2 only through rterm and
//   dirterm; their gradients are folded here from rbf, x_dir and the
//   per-edge cotangents, which never leave the chip.
// The edge geometry gets no gradient, as in the TPU kernel.
//
// Numerics follow `_bwd_kernel`: the forward is recomputed exactly as K2
// computes it (csrc/pp_message.cu); every backward product is accumulated
// in fp32 and rounded once to the compute type T; the SiLU and sigmoid
// derivatives run in fp32; the channel-norm backward is r = dsh / sh where
// sh > 1e-4, else 0, with sh the fp32 norm. With T = float every rounding
// is the identity.
//
// Design. Persistent blocks of 256 threads, one an SM (the grid is blocks
// per SM x SMs, queried once and cached). A work item is a batch row and a
// tile of min(64, 256 / K) destinations. The call's edge rows are the valid
// slots (mask set, index in range) of all items in item order; a first
// kernel counts each item's, and block x takes an equal share of the rows
// (rows [x N / grid, (x + 1) N / grid)), so the blocks' work differs by at
// most a row whatever the pockets' density. A block compacts its items'
// valid slots with a block prefix sum into a ring of rows (table row, slot,
// output row, mask) and each chunk takes the next kR rows across item
// boundaries, so only its last chunk is partial. No sum crosses a chunk
// edge: a row reads its destination's cotangent and scatters to its
// source. kR is 32 rows, or 16 where the chain's stored stages do not fit
// at 32 (five or more GVPs at S=128, V=16): for a chunk the block recomputes
// the chain and keeps every stage it needs (vh, z, gate and vu of each GVP;
// about 240 floats a row a GVP) in shared memory as [channel][row] fp32
// columns, then walks the GVPs backwards with its cotangent columns beside
// them (~196 KB at three GVPs and 32 rows).
//
// Products run on the fp32 FMA units. The weights are read from global
// memory, transposed in the read where the backward needs W^T: the chain's
// 187 KB of fp32 weights do not fit beside the stages, so they come from
// the L2, and the latency of those reads is what a chunk waits on. So a
// thread of an S-wide product holds a 4 x 4 register tile (the S x S ones
// read their weights 16 bytes at a time), the 128-deep 16-wide products
// split their depth over the 8 lanes of a lane octet and add the parts
// with shuffles, and the S-wide weight gradients use 4 x 4 tiles too.
//
// Sums. A source atom is the neighbour of many destinations and may occur
// twice in one list, so the node-table gradients are fp32 atomicAdd into
// [B,P,.] (~16 rows each; their last bits vary from run to run). Each
// weight gradient is summed per block: the block adds every chunk's fp32
// sum into its own slice of a scratch buffer [grid, n_w] with plain loads
// and stores (132 x 48,977 floats at the training shape, which stay in the
// L2), and sum_slices_kernel adds the slices in block order in fp64. No
// atomic touches the weight gradients, so they are the same in every run;
// summed in fp32 atomics over ~630 chunk sums instead, some elements moved
// by up to the whole fp32 tolerance from one run to the next (PERF.md).
// Masked slots, out-of-range indices and the padding rows of the last
// chunk contribute nothing.
//
// Bound: at the training shape (B=32, P=Nd=256, K=16, S=128, V=16, three
// GVPs) the recompute plus the backward are ~145 k multiply-adds per valid
// edge row against ~90 MB of inputs and outputs (PERF.md); the sparse pp
// lists make the valid rows, not the slots, the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // also the most slots a work item holds
constexpr int kDests = 64;            // the most destinations a work item holds
constexpr int kRing = 512;            // compacted rows a block holds: >= kR - 1 + kThreads
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use (Hopper)

// Edge rows per chunk, kR, is a template parameter: 32, or 16 for chains
// whose stored stages do not fit at 32 (rows_for). Row strides of the
// [channel][row] columns and of the 3-plane vector columns:
__host__ __device__ constexpr int ld1(int kR) { return kR + 4; }
__host__ __device__ constexpr int ld3(int kR) { return 3 * kR + 4; }

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an fp32 value to T and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float dsilu_f(float z) {
  const float sg = sigmoid_f(z);
  return sg * (1.0f + z * (1.0f - sg));
}

struct Dims {
  int B, P, copies, Nd, K, S, V, H0, Hj, R, n_layers, tile_n, tiles, items;
};

// Offsets (elements) of the packed T weights; must match K2's
// (csrc/pp_message.cu) and ops/pp_message.py::_pack_weights.
struct Layer0 { int w1_sh, wg, bg, wu; };
struct LayerJ { int wh, wu, w1f, w1sh, b1, wg, bg; };

__host__ __device__ inline int layer0_size(const Dims& d) {
  return pad8(d.H0 * d.S) + pad8(d.S * d.V) + pad8(d.V) + pad8(d.H0 * d.V);
}
__host__ __device__ inline int layerj_size(const Dims& d) {
  return pad8(d.V * d.Hj) + pad8(d.Hj * d.V) + pad8(d.S * d.S) + pad8(d.Hj * d.S) +
         pad8(d.S) + pad8(d.S * d.V) + pad8(d.V);
}
__device__ inline Layer0 layer0_offsets(const Dims& d) {
  Layer0 o;
  o.w1_sh = 0;
  o.wg = o.w1_sh + pad8(d.H0 * d.S);
  o.bg = o.wg + pad8(d.S * d.V);
  o.wu = o.bg + pad8(d.V);
  return o;
}
__device__ inline LayerJ layerj_offsets(const Dims& d, int j) {
  LayerJ o;
  o.wh = layer0_size(d) + (j - 1) * layerj_size(d);
  o.wu = o.wh + pad8(d.V * d.Hj);
  o.w1f = o.wu + pad8(d.Hj * d.V);
  o.w1sh = o.w1f + pad8(d.S * d.S);
  o.b1 = o.w1sh + pad8(d.Hj * d.S);
  o.wg = o.b1 + pad8(d.S);
  o.bg = o.wg + pad8(d.S * d.V);
  return o;
}

// Offsets (elements) of the fp32 gradient buffer, in split_weights order.
struct Grad0 { int wh0, wu, w1d, w1sh, b1, wg, bg; };
struct GradJ { int wh, wu, w1f, w1sh, b1, wg, bg; };

__host__ __device__ inline int grad0_size(const Dims& d) {
  return d.H0 + d.H0 * d.V + d.R * d.S + d.H0 * d.S + d.S + d.S * d.V + d.V;
}
__host__ __device__ inline int gradj_size(const Dims& d) {
  return d.V * d.Hj + d.Hj * d.V + d.S * d.S + d.Hj * d.S + d.S + d.S * d.V + d.V;
}
__device__ inline Grad0 grad0_offsets(const Dims& d) {
  Grad0 o;
  o.wh0 = 0;
  o.wu = o.wh0 + d.H0;
  o.w1d = o.wu + d.H0 * d.V;
  o.w1sh = o.w1d + d.R * d.S;
  o.b1 = o.w1sh + d.H0 * d.S;
  o.wg = o.b1 + d.S;
  o.bg = o.wg + d.S * d.V;
  return o;
}
__device__ inline GradJ gradj_offsets(const Dims& d, int j) {
  GradJ o;
  o.wh = grad0_size(d) + (j - 1) * gradj_size(d);
  o.wu = o.wh + d.V * d.Hj;
  o.w1f = o.wu + d.Hj * d.V;
  o.w1sh = o.w1f + d.S * d.S;
  o.b1 = o.w1sh + d.Hj * d.S;
  o.wg = o.b1 + d.S;
  o.bg = o.wg + d.S * d.V;
  return o;
}

// C[r][n] = sum_{k < kd} A[k * lda + r] * wt(k, n) for rows r < m (a
// multiple of 4) and columns n < n_out; epi(r, n, fp32 sum) runs once per
// output. Each thread owns 4 consecutive rows of one column.
template <class WF, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int m, int kd, int n_out, WF wt,
                                     Epi epi) {
  const int groups = m / 4;
  for (int task = threadIdx.x; task < groups * n_out; task += kThreads) {
    const int rg = task % groups, n = task / groups;
    const float* a = A + 4 * rg;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kd; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
      const float w = wt(k, n);
      c0 = fmaf(av.x, w, c0);
      c1 = fmaf(av.y, w, c1);
      c2 = fmaf(av.z, w, c2);
      c3 = fmaf(av.w, w, c3);
    }
    epi(4 * rg + 0, n, c0);
    epi(4 * rg + 1, n, c1);
    epi(4 * rg + 2, n, c2);
    epi(4 * rg + 3, n, c3);
  }
}

// The same product with a 4-row x 4-column register tile a thread, for
// outputs S wide: per k one shared-memory load and four weights feed 16
// multiply-adds, so a thread has 4x fewer weight loads in its dependent
// chain than `gemm` (the weights come from the L2: they do not fit in the
// L1 beside the shared memory).
template <class WF, class Epi>
__device__ __forceinline__ void gemm4(const float* A, int lda, int m, int kd, int n_out, WF wt,
                                      Epi epi) {
  const int groups = m / 4, tiles = groups * ((n_out + 3) / 4);
  for (int task = threadIdx.x; task < tiles; task += kThreads) {
    const int rg = task % groups, n0 = 4 * (task / groups);
    const float* a = A + 4 * rg;
    int nn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nn[j] = min(n0 + j, n_out - 1);  // loads stay in range
    float c[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < kd; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = wt(k, nn[j]);
        c[0][j] = fmaf(av.x, w, c[0][j]);
        c[1][j] = fmaf(av.y, w, c[1][j]);
        c[2][j] = fmaf(av.z, w, c[2][j]);
        c[3][j] = fmaf(av.w, w, c[3][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < n_out) epi(4 * rg + i, n0 + j, c[i][j]);
  }
}

// 4 consecutive T weights as fp32 (p 16-byte aligned for float, 8 for bf16)
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// `gemm4` for the S x S products, W read 16 (bf16: 8) bytes at a time:
// C[r][n] = sum_k A[k][r] * W[k * ldw + n] or, kTrans, W[n * ldw + k].
// kd, n_out and ldw multiples of 4 (`s4` in the kernel, else `gemm4`).
template <bool kTrans, typename T, class Epi>
__device__ __forceinline__ void gemm4v(const float* A, int lda, int m, int kd, int n_out,
                                       const T* __restrict__ W, int ldw, Epi epi) {
  const int groups = m / 4, tiles = groups * (n_out / 4);
  for (int task = threadIdx.x; task < tiles; task += kThreads) {
    const int rg = task % groups, n0 = 4 * (task / groups);
    const float* a = A + 4 * rg;
    float c[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < kd; k += 4) {
      float4 w[4], av[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = kTrans ? load4(W + (n0 + q) * ldw + k) : load4(W + (k + q) * ldw + n0);
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = *reinterpret_cast<const float4*>(a + (k + q) * lda);
      float wk[4][4];  // wk[q][j]: the weight of depth k + q, column n0 + j
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float e[4] = {w[q].x, w[q].y, w[q].z, w[q].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) (kTrans ? wk[j][q] : wk[q][j]) = e[j];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[0][j] = fmaf(av[q].x, wk[q][j], c[0][j]);
          c[1][j] = fmaf(av[q].y, wk[q][j], c[1][j]);
          c[2][j] = fmaf(av[q].z, wk[q][j], c[2][j]);
          c[3][j] = fmaf(av[q].w, wk[q][j], c[3][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(4 * rg + i, n0 + j, c[i][j]);
  }
}

// The same product for narrow outputs of a deep product (depth S, 16 or 17
// columns): 4 x 4 tiles whose depth is split over the 8 lanes of a lane
// octet (lane kq takes k = kq, kq + 8, ...); the octet's partial sums are
// added with shuffles and its first lane runs the epilogue. Every thread
// takes part, with 8x shorter chains than a thread a column.
template <class WF, class Epi>
__device__ __forceinline__ void gemm_sk(const float* A, int lda, int m, int kd, int n_out, WF wt,
                                        Epi epi) {
  const int groups = m / 4, tiles = groups * ((n_out + 3) / 4);
  const int lane = threadIdx.x & 31, kq = lane & 7;
  // t0 is the same across a warp, so every lane reaches the shuffles
  for (int t0 = (threadIdx.x >> 5) * 4; t0 < tiles; t0 += kThreads / 8) {
    const int task = t0 + (lane >> 3);
    const bool on = task < tiles;
    const int rg = on ? task % groups : 0, n0 = on ? 4 * (task / groups) : 0;
    const float* a = A + 4 * rg;
    int nn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nn[j] = min(n0 + j, n_out - 1);
    float c[4][4] = {};
    if (on) {
#pragma unroll 4
      for (int k = kq; k < kd; k += 8) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = wt(k, nn[j]);
          c[0][j] = fmaf(av.x, w, c[0][j]);
          c[1][j] = fmaf(av.y, w, c[1][j]);
          c[2][j] = fmaf(av.z, w, c[2][j]);
          c[3][j] = fmaf(av.w, w, c[3][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int off = 4; off >= 1; off >>= 1)
          c[i][j] += __shfl_xor_sync(0xffffffffu, c[i][j], off);
    if (on && kq == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < n_out) epi(4 * rg + i, n0 + j, c[i][j]);
  }
}

// A block's weight-gradient sums live in its own slice. `held` reads an
// element's sum so far (0 before the block's first chunk); it is issued
// before the chunk's sum is computed, so its latency hides behind that,
// and the new sum goes back with a plain store.
__device__ __forceinline__ float held(const float* p, bool first) { return first ? 0.0f : *p; }

// gw[x * ny + y] += sum_{r < m} A[x * lda + r] * B[y * ldb + r]: a weight
// gradient over the chunk's rows (m a multiple of 4), summed in fp32 into the
// block's slice (`held`).
__device__ __forceinline__ void dot_t(const float* A, int lda, int nx, const float* B, int ldb,
                                      int ny, int m, float* gw, bool first) {
  for (int task = threadIdx.x; task < nx * ny; task += kThreads) {
    const int y = task % ny, x = task / ny;
    const float* a = A + x * lda;
    const float* b = B + y * ldb;
    const float sum = held(gw + task, first);
    float acc = 0.0f;
#pragma unroll 4
    for (int r = 0; r < m; r += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + r);
      const float4 bv = *reinterpret_cast<const float4*>(b + r);
      acc = fmaf(av.x, bv.x, acc);
      acc = fmaf(av.y, bv.y, acc);
      acc = fmaf(av.z, bv.z, acc);
      acc = fmaf(av.w, bv.w, acc);
    }
    gw[task] = sum + acc;
  }
}

// `dot_t` with a 4 x 4 register tile of (x, y) a thread, for gradients with
// an S-wide side: 8 shared-memory loads feed 64 multiply-adds. Each thread
// walks the row groups from its own offset (ty mod groups), so the eight
// threads of a quarter warp load from distinct banks; each element's sum
// still runs in a fixed order.
__device__ __forceinline__ void dot4(const float* A, int lda, int nx, const float* B, int ldb,
                                     int ny, int m, float* gw, bool first) {
  const int xg = (nx + 3) / 4, yg = (ny + 3) / 4, groups = m / 4;
  for (int task = threadIdx.x; task < xg * yg; task += kThreads) {
    const int ty = task % yg, tx = task / yg;
    const float* a[4];
    const float* b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A + min(4 * tx + i, nx - 1) * lda;  // loads stay in range
      b[i] = B + min(4 * ty + i, ny - 1) * ldb;
    }
    float sum[4][4], c[4][4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum[i][j] = 4 * tx + i < nx && 4 * ty + j < ny
                        ? held(gw + (4 * tx + i) * ny + 4 * ty + j, first)
                        : 0.0f;
    int g = ty % groups;
    for (int step = 0; step < groups; ++step) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a[i] + 4 * g);
        bv[i] = *reinterpret_cast<const float4*>(b[i] + 4 * g);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
          c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
          c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
          c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
        }
      if (++g == groups) g = 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + i < nx && 4 * ty + j < ny)
          gw[(4 * tx + i) * ny + 4 * ty + j] = sum[i][j] + c[i][j];
  }
}

// gw[y] += sum_{r < kR} B[y * ldb + r] (a bias gradient).
template <int kR>
__device__ __forceinline__ void colsum(const float* B, int ldb, int ny, float* gw, bool first) {
  for (int y = threadIdx.x; y < ny; y += kThreads) {
    const float sum = held(gw + y, first);
    float acc = 0.0f;
    for (int r = 0; r < kR; ++r) acc += B[y * ldb + r];
    gw[y] = sum + acc;
  }
}

// SH[h][r] = T(|VH[h][plane c][r]|) over the three planes, clamped at 1e-8.
template <typename T, int kR>
__device__ void channel_norms(const float* VH, float* SH, int h) {
  constexpr int kLd = ld1(kR), kLd3 = ld3(kR);
  for (int i = threadIdx.x; i < h * kR; i += kThreads) {
    const int c = i / kR, r = i - c * kR;
    const float* v = VH + c * kLd3 + r;
    const float x = v[0], y = v[kR], z = v[2 * kR];
    SH[c * kLd + r] = rnd<T>(sqrtf(fmaxf(x * x + y * y + z * z, 1e-8f)));
  }
}

// Exclusive prefix sum of `flag` over the block; *total gets the sum.
__device__ int block_scan(int flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_sums[w];
      warp_sums[w] = run;
      run += c;
    }
    *total = run;
  }
  __syncthreads();
  return warp_sums[warp] + x - flag;
}

// Shared-memory layout (floats); see smem_floats.
struct Smem {
  float *VH, *Z, *G, *VU;                 // per GVP: stored forward stages
  float *F, *SH, *VT;                     // feats, rounded norms, vec
  float *DF, *DZ, *DV, *DH, *DG, *DR;     // cotangents
  float *RB, *XD;                         // chunk rows' rbf and x_dir
  float* MR;                              // chunk rows: mask,
  int *JR, *ER, *OR;                      // table row b * P + j, slot, output row
  float* ML;                              // ring of compacted rows: the same
  int *TR, *EL, *OL, *WS;
};

__host__ __device__ inline int hmax(const Dims& d) { return d.H0 > d.Hj ? d.H0 : d.Hj; }

__host__ __device__ inline size_t layer_floats(const Dims& d, int kR) {
  const int Hm = hmax(d), kLd = ld1(kR), kLd3 = ld3(kR);
  return static_cast<size_t>(Hm) * kLd3 + static_cast<size_t>(d.S) * kLd +
         static_cast<size_t>(d.V) * kLd + static_cast<size_t>(d.V) * kLd3;
}

__host__ __device__ inline size_t smem_floats(const Dims& d, int kR) {
  const int Hm = hmax(d), kLd = ld1(kR), kLd3 = ld3(kR);
  return d.n_layers * layer_floats(d, kR) + 3 * static_cast<size_t>(d.S) * kLd +
         static_cast<size_t>(Hm) * kLd * 2 + static_cast<size_t>(d.V) * kLd3 * 2 +
         static_cast<size_t>(Hm) * kLd3 + static_cast<size_t>(d.V) * kLd +
         static_cast<size_t>(d.R) * kLd + 7 * kR + 4 * kRing + 32;
}

// The chunk height that fits: 32 rows, else 16 (0 if neither fits).
inline int rows_for(const Dims& d) {
  for (const int r : {32, 16})
    if (smem_floats(d, r) * sizeof(float) <= static_cast<size_t>(kMaxSmem)) return r;
  return 0;
}

__device__ Smem carve(float* base, const Dims& d, int kR) {
  const int Hm = hmax(d), kLd = ld1(kR), kLd3 = ld3(kR);
  Smem m;
  float* p = base;
  m.VH = p; p += d.n_layers * Hm * kLd3;
  m.Z = p; p += d.n_layers * d.S * kLd;
  m.G = p; p += d.n_layers * d.V * kLd;
  m.VU = p; p += d.n_layers * d.V * kLd3;
  m.F = p; p += d.S * kLd;
  m.DF = p; p += d.S * kLd;
  m.DZ = p; p += d.S * kLd;
  m.SH = p; p += Hm * kLd;
  m.DR = p; p += Hm * kLd;
  m.VT = p; p += d.V * kLd3;
  m.DV = p; p += d.V * kLd3;
  m.DH = p; p += Hm * kLd3;
  m.DG = p; p += d.V * kLd;
  m.RB = p; p += d.R * kLd;
  m.XD = p; p += 3 * kR;
  m.MR = p; p += kR;
  m.JR = reinterpret_cast<int*>(p); p += kR;
  m.ER = reinterpret_cast<int*>(p); p += kR;
  m.OR = reinterpret_cast<int*>(p); p += kR;
  m.ML = p; p += kRing;
  m.TR = reinterpret_cast<int*>(p); p += kRing;
  m.EL = reinterpret_cast<int*>(p); p += kRing;
  m.OL = reinterpret_cast<int*>(p); p += kRing;
  m.WS = reinterpret_cast<int*>(p);
  return m;
}

template <typename T, int kR>
__global__ void __launch_bounds__(kThreads, 1)
pp_message_bwd_kernel(const T* __restrict__ tab_s, const T* __restrict__ tab_v,
                      const int* __restrict__ idx, const float* __restrict__ mask,
                      const T* __restrict__ rterm, const T* __restrict__ dirterm,
                      const T* __restrict__ rbf, const T* __restrict__ xdir,
                      const T* __restrict__ wts, const float* __restrict__ ds,
                      const float* __restrict__ dv, Dims d, float* __restrict__ d_tab_s,
                      float* __restrict__ d_tab_v, const int* __restrict__ counts,
                      float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = ld1(kR), kLd3 = ld3(kR);
  const Smem sm = carve(reinterpret_cast<float*>(smem4), d, kR);
  const int S = d.S, V = d.V, H0 = d.H0, Hj = d.Hj, K = d.K, TN = d.tile_n, L = d.n_layers;
  const int Hm = hmax(d);

  const int tid = threadIdx.x;
  // the S x S products read their weights 4 at a time (the packed weights
  // start every matrix at a multiple of 8 elements)
  const bool s4 = S % 4 == 0;

  // ---- this block's share of the call's edge rows --------------------------
  // The valid slots (mask set, index in range) of all work items, in item
  // order, are the call's rows; block x takes rows [lo, hi), an equal share.
  // From the items' counts (count_kernel) it finds the item holding row lo
  // (`next`) and that item's first row (`base`).
  int total = 0;
  for (int i0 = 0; i0 < d.items; i0 += kThreads) {
    block_scan(i0 + tid < d.items ? counts[i0 + tid] : 0, sm.WS, sm.WS + 8);
    total += sm.WS[8];
    __syncthreads();
  }
  const int lo = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
  if (tid == 0) {
    sm.WS[16] = d.items;  // an empty share: no item, no row before hi
    sm.WS[17] = total;
  }
  __syncthreads();
  int base = 0;
  for (int i0 = 0; i0 < d.items && lo < hi; i0 += kThreads) {
    const int i = i0 + tid, c = i < d.items ? counts[i] : 0;
    const int start = base + block_scan(c, sm.WS, sm.WS + 8);
    if (c > 0 && start <= lo && lo < start + c) {
      sm.WS[16] = i;
      sm.WS[17] = start;
    }
    base += sm.WS[8];
    __syncthreads();
    if (sm.WS[16] < d.items) break;
  }
  int next = sm.WS[16];
  base = sm.WS[17];

  // Append the valid slots of work item `item`, whose first row is `base`,
  // that lie in [lo, hi) to the ring at `tail`, in slot order; returns how
  // many valid slots the item has.
  auto compact = [&](int item, int tail, int base) -> int {
    const int b = item / d.tiles, tile = item - b * d.tiles;
    const int g = b / d.copies, n0 = tile * TN;
    const int e0 = (g * d.Nd + n0) * K;  // first slot
    const int nl = tid / K;
    int flag = 0, j = -1;
    float m = 0.0f;
    if (tid < TN * K && n0 + nl < d.Nd) {
      j = idx[e0 + tid];
      m = mask[e0 + tid];
      flag = m != 0.0f && j >= 0 && j < d.P;
    }
    const int pos = block_scan(flag, sm.WS, sm.WS + 8);
    const int n_valid = sm.WS[8];
    if (flag && base + pos >= lo && base + pos < hi) {
      const int q = (tail + base + pos - max(lo, base)) & (kRing - 1);
      sm.ML[q] = m;
      sm.TR[q] = b * d.P + j;
      sm.EL[q] = e0 + tid;
      sm.OL[q] = b * d.Nd + n0 + nl;
    }
    __syncthreads();
    return n_valid;
  };

  const Layer0 o0 = layer0_offsets(d);
  const Grad0 q0 = grad0_offsets(d);
  const int w3 = 3 * H0;
  // per-GVP stored stages
  auto VHl = [&](int l) { return sm.VH + l * Hm * kLd3; };
  auto Zl = [&](int l) { return sm.Z + l * S * kLd; };
  auto Gl = [&](int l) { return sm.G + l * V * kLd; };
  auto VUl = [&](int l) { return sm.VU + l * V * kLd3; };

  // this block's slice of the weight-gradient sums (split_weights order)
  const int n_w = grad0_size(d) + (L - 1) * gradj_size(d);
  float* const gw = part + static_cast<size_t>(blockIdx.x) * n_w;
  // The block's items stream through the ring: each chunk takes the next kR
  // rows, across item boundaries, so only the block's last chunk is partial.
  int head = 0, tail = 0;
  bool first = true;
  for (;; first = false) {
    while (tail - head < kR && base < hi) {
      const int n_valid = compact(next++, tail, base);
      tail += min(hi, base + n_valid) - max(lo, base);
      base += n_valid;
    }
    const int nr = min(kR, tail - head);
    if (nr == 0) break;
    // ---- this chunk's rows: gather + group-level terms + geometry ----------
    for (int r = tid; r < kR; r += kThreads) {
      const bool on = r < nr;
      const int q = (head + r) & (kRing - 1);
      sm.MR[r] = on ? sm.ML[q] : 0.0f;
      sm.JR[r] = on ? sm.TR[q] : -1;
      sm.ER[r] = on ? sm.EL[q] : -1;
      sm.OR[r] = on ? sm.OL[q] : -1;
    }
    head += nr;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < kR * S; i += kThreads) {
      const int r = i / S, s = i - r * S;
      const int jr = sm.JR[r];
      sm.F[s * kLd + r] = jr >= 0 ? rnd<T>(to_f(tab_s[static_cast<size_t>(jr) * S + s]) +
                                           to_f(rterm[static_cast<size_t>(sm.ER[r]) * S + s]))
                                  : 0.0f;
    }
    float* VH0 = VHl(0);
#pragma unroll 4
    for (int i = tid; i < kR * w3; i += kThreads) {
      const int r = i / w3, ch = i - r * w3;  // ch = plane * H0 + h
      const int c = ch / H0, h = ch - c * H0;
      const int jr = sm.JR[r];
      VH0[h * kLd3 + c * kR + r] =
          jr >= 0 ? rnd<T>(to_f(tab_v[static_cast<size_t>(jr) * w3 + ch]) +
                           to_f(dirterm[static_cast<size_t>(sm.ER[r]) * w3 + ch]))
                  : 0.0f;
    }
    for (int i = tid; i < kR * d.R; i += kThreads) {
      const int r = i / d.R, x = i - r * d.R;
      sm.RB[x * kLd + r] =
          sm.JR[r] >= 0 ? to_f(rbf[static_cast<size_t>(sm.ER[r]) * d.R + x]) : 0.0f;
    }
    for (int i = tid; i < kR * 3; i += kThreads) {
      const int r = i / 3, c = i - r * 3;
      sm.XD[c * kR + r] =
          sm.JR[r] >= 0 ? to_f(xdir[static_cast<size_t>(sm.ER[r]) * 3 + c]) : 0.0f;
    }
    __syncthreads();

    // ---- forward recompute, GVP 0 (as K2) ------------------------------------
    channel_norms<T, kR>(VH0, sm.SH, H0);
    __syncthreads();
    {
      float* Z0 = Zl(0);
      const T* W = wts + o0.w1_sh;
      gemm4(sm.SH, kLd, kR, H0, S, [&](int k, int n) { return to_f(W[k * S + n]); },
           [&](int r, int n, float acc) {
             const float z = rnd<T>(sm.F[n * kLd + r] + rnd<T>(acc));
             Z0[n * kLd + r] = z;
             sm.F[n * kLd + r] = rnd<T>(z * sigmoid_f(z));
           });
    }
    __syncthreads();
    {
      float* G0 = Gl(0);
      float* VU0 = VUl(0);
      const T* Wg = wts + o0.wg;
      const T* Bg = wts + o0.bg;
      const T* Wu = wts + o0.wu;
      gemm_sk(sm.F, kLd, kR, S, V, [&](int k, int n) { return to_f(Wg[k * V + n]); },
           [&](int r, int n, float acc) {
             G0[n * kLd + r] = rnd<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + to_f(Bg[n]))));
           });
      gemm(VH0, kLd3, 3 * kR, H0, V, [&](int k, int n) { return to_f(Wu[k * V + n]); },
           [&](int row, int n, float acc) { VU0[n * kLd3 + row] = rnd<T>(acc); });
    }
    __syncthreads();
    for (int i = tid; i < V * 3 * kR; i += kThreads) {
      const int v = i / (3 * kR), row = i - v * 3 * kR;
      sm.VT[v * kLd3 + row] = rnd<T>(Gl(0)[v * kLd + row % kR] * VUl(0)[v * kLd3 + row]);
    }
    __syncthreads();

    // ---- forward recompute, GVPs 1 .. L-1 -------------------------------------
    for (int l = 1; l < L; ++l) {
      const LayerJ o = layerj_offsets(d, l);
      float* VHc = VHl(l);
      float* Zc = Zl(l);
      {
        const T* W = wts + o.wh;
        gemm(sm.VT, kLd3, 3 * kR, V, Hj, [&](int k, int n) { return to_f(W[k * Hj + n]); },
             [&](int row, int n, float acc) { VHc[n * kLd3 + row] = rnd<T>(acc); });
      }
      __syncthreads();
      channel_norms<T, kR>(VHc, sm.SH, Hj);
      {
        const T* W = wts + o.w1f;
        const auto epi = [&](int r, int n, float acc) { Zc[n * kLd + r] = rnd<T>(acc); };
        if (s4)
          gemm4v<false>(sm.F, kLd, kR, S, S, W, S, epi);
        else
          gemm4(sm.F, kLd, kR, S, S, [&](int k, int n) { return to_f(W[k * S + n]); }, epi);
      }
      __syncthreads();
      {
        const T* W = wts + o.w1sh;
        const T* B1 = wts + o.b1;
        gemm4(sm.SH, kLd, kR, Hj, S, [&](int k, int n) { return to_f(W[k * S + n]); },
             [&](int r, int n, float acc) {
               Zc[n * kLd + r] =
                   rnd<T>(rnd<T>(Zc[n * kLd + r] + rnd<T>(acc)) + to_f(B1[n]));
             });
      }
      __syncthreads();
      for (int i = tid; i < S * kR; i += kThreads) {
        const int s = i / kR, r = i - s * kR;
        const float z = Zc[s * kLd + r];
        sm.F[s * kLd + r] = rnd<T>(z * sigmoid_f(z));
      }
      __syncthreads();
      {
        float* Gc = Gl(l);
        float* VUc = VUl(l);
        const T* Wg = wts + o.wg;
        const T* Bg = wts + o.bg;
        const T* Wu = wts + o.wu;
        gemm_sk(sm.F, kLd, kR, S, V, [&](int k, int n) { return to_f(Wg[k * V + n]); },
             [&](int r, int n, float acc) {
               Gc[n * kLd + r] = rnd<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + to_f(Bg[n]))));
             });
        gemm(VHc, kLd3, 3 * kR, Hj, V, [&](int k, int n) { return to_f(Wu[k * V + n]); },
             [&](int row, int n, float acc) { VUc[n * kLd3 + row] = rnd<T>(acc); });
      }
      __syncthreads();
      for (int i = tid; i < V * 3 * kR; i += kThreads) {
        const int v = i / (3 * kR), row = i - v * 3 * kR;
        sm.VT[v * kLd3 + row] = rnd<T>(Gl(l)[v * kLd + row % kR] * VUl(l)[v * kLd3 + row]);
      }
      __syncthreads();
    }

    // ---- cotangent seeds: the masked broadcast over the K slots --------------
#pragma unroll 4
    for (int i = tid; i < kR * S; i += kThreads) {
      const int r = i / S, s = i - r * S;
      const int o = sm.OR[r];
      sm.DF[s * kLd + r] = o >= 0 ? rnd<T>(ds[static_cast<size_t>(o) * S + s] * sm.MR[r]) : 0.0f;
    }
#pragma unroll 4
    for (int i = tid; i < kR * 3 * V; i += kThreads) {
      const int r = i / (3 * V), q = i - r * 3 * V;  // q = v * 3 + plane
      const int v = q / 3, c = q - v * 3;
      const int o = sm.OR[r];
      sm.DV[v * kLd3 + c * kR + r] =
          o >= 0 ? rnd<T>(dv[static_cast<size_t>(o) * 3 * V + q] * sm.MR[r]) : 0.0f;
    }
    __syncthreads();

    // ---- GVPs L-1 .. 0, reversed ---------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const int Hl = l == 0 ? H0 : Hj;
      const float* VHc = VHl(l);
      const float* Zc = Zl(l);
      const float* Gc = Gl(l);
      const float* VUc = VUl(l);
      const T *Wg, *Wu, *W1sh;
      float *gwg, *gbg, *gwu, *gw1sh, *gb1;
      if (l == 0) {
        Wg = wts + o0.wg; Wu = wts + o0.wu; W1sh = wts + o0.w1_sh;
        gwg = gw + q0.wg; gbg = gw + q0.bg; gwu = gw + q0.wu; gw1sh = gw + q0.w1sh;
        gb1 = gw + q0.b1;
      } else {
        const LayerJ o = layerj_offsets(d, l);
        const GradJ q = gradj_offsets(d, l);
        Wg = wts + o.wg; Wu = wts + o.wu; W1sh = wts + o.w1sh;
        gwg = gw + q.wg; gbg = gw + q.bg; gwu = gw + q.wu; gw1sh = gw + q.w1sh;
        gb1 = gw + q.b1;
      }

      // feats of this GVP; gate backward: dgate, dzg and dvu (DV in place)
      for (int i = tid; i < S * kR; i += kThreads) {
        const int s = i / kR, r = i - s * kR;
        const float z = Zc[s * kLd + r];
        sm.F[s * kLd + r] = rnd<T>(z * sigmoid_f(z));
      }
      for (int i = tid; i < V * kR; i += kThreads) {
        const int v = i / kR, r = i - v * kR;
        const float gt = Gc[v * kLd + r];
        float* dvec = sm.DV + v * kLd3 + r;
        const float* vu = VUc + v * kLd3 + r;
        const float dg = dvec[0] * vu[0] + dvec[kR] * vu[kR] + dvec[2 * kR] * vu[2 * kR];
        sm.DG[v * kLd + r] = rnd<T>(dg * gt * (1.0f - gt));
        dvec[0] = rnd<T>(dvec[0] * gt);
        dvec[kR] = rnd<T>(dvec[kR] * gt);
        dvec[2 * kR] = rnd<T>(dvec[2 * kR] * gt);
      }
      __syncthreads();

      // d_wg, d_bg, d_wu; dfeats += dzg @ wg^T; dvh = dvu @ wu^T
      dot4(sm.F, kLd, S, sm.DG, kLd, V, kR, gwg, first);
      colsum<kR>(sm.DG, kLd, V, gbg, first);
      dot_t(VHc, kLd3, Hl, sm.DV, kLd3, V, 3 * kR, gwu, first);
      gemm4(sm.DG, kLd, kR, V, S, [&](int k, int n) { return to_f(Wg[n * V + k]); },
           [&](int r, int n, float acc) {
             sm.DF[n * kLd + r] = rnd<T>(sm.DF[n * kLd + r] + rnd<T>(acc));
           });
      gemm(sm.DV, kLd3, 3 * kR, V, Hl, [&](int k, int n) { return to_f(Wu[n * V + k]); },
           [&](int row, int n, float acc) { sm.DH[n * kLd3 + row] = rnd<T>(acc); });
      __syncthreads();

      // dz = dfeats * silu'(z); the norms' input side: rounded norms, and
      // the previous GVP's feats (for d_w1f)
      for (int i = tid; i < S * kR; i += kThreads) {
        const int s = i / kR, r = i - s * kR;
        sm.DZ[s * kLd + r] = rnd<T>(sm.DF[s * kLd + r] * dsilu_f(Zc[s * kLd + r]));
        if (l > 0) {
          const float zp = Zl(l - 1)[s * kLd + r];
          sm.F[s * kLd + r] = rnd<T>(zp * sigmoid_f(zp));
        }
      }
      channel_norms<T, kR>(VHc, sm.SH, Hl);
      __syncthreads();

      // d_b1, d_w1f (or d_w1d), d_w1sh; dsh = dz @ w1sh^T
      colsum<kR>(sm.DZ, kLd, S, gb1, first);
      if (l > 0)
        dot4(sm.F, kLd, S, sm.DZ, kLd, S, kR, gw + gradj_offsets(d, l).w1f, first);
      else
        dot4(sm.RB, kLd, d.R, sm.DZ, kLd, S, kR, gw + q0.w1d, first);
      dot4(sm.SH, kLd, Hl, sm.DZ, kLd, S, kR, gw1sh, first);
      gemm_sk(sm.DZ, kLd, kR, S, Hl, [&](int k, int n) { return to_f(W1sh[n * S + k]); },
           [&](int r, int n, float acc) { sm.DR[n * kLd + r] = rnd<T>(acc); });
      __syncthreads();

      // dvh += T(vh * r), r = dsh / sh where sh > 1e-4; previous GVP's vec
      for (int i = tid; i < Hl * kR; i += kThreads) {
        const int h = i / kR, r = i - h * kR;
        const float* vh = VHc + h * kLd3 + r;
        const float x = vh[0], y = vh[kR], z = vh[2 * kR];
        const float sh = sqrtf(fmaxf(x * x + y * y + z * z, 1e-8f));
        const float rr = sh > 1e-4f ? sm.DR[h * kLd + r] / sh : 0.0f;
        float* dh = sm.DH + h * kLd3 + r;
        dh[0] = rnd<T>(dh[0] + rnd<T>(x * rr));
        dh[kR] = rnd<T>(dh[kR] + rnd<T>(y * rr));
        dh[2 * kR] = rnd<T>(dh[2 * kR] + rnd<T>(z * rr));
      }
      if (l > 0) {
        for (int i = tid; i < V * 3 * kR; i += kThreads) {
          const int v = i / (3 * kR), row = i - v * 3 * kR;
          sm.VT[v * kLd3 + row] =
              rnd<T>(Gl(l - 1)[v * kLd + row % kR] * VUl(l - 1)[v * kLd3 + row]);
        }
      }
      __syncthreads();

      if (l > 0) {
        // d_wh; dvec = dvh @ wh^T; dfeats = dz @ w1f^T
        const LayerJ o = layerj_offsets(d, l);
        const T* Wh = wts + o.wh;
        const T* W1f = wts + o.w1f;
        dot_t(sm.VT, kLd3, V, sm.DH, kLd3, Hj, 3 * kR, gw + gradj_offsets(d, l).wh, first);
        gemm(sm.DH, kLd3, 3 * kR, Hj, V, [&](int k, int n) { return to_f(Wh[n * Hj + k]); },
             [&](int row, int n, float acc) { sm.DV[n * kLd3 + row] = rnd<T>(acc); });
        const auto epi = [&](int r, int n, float acc) { sm.DF[n * kLd + r] = rnd<T>(acc); };
        if (s4)
          gemm4v<true>(sm.DZ, kLd, kR, S, S, W1f, S, epi);
        else
          gemm4(sm.DZ, kLd, kR, S, S, [&](int k, int n) { return to_f(W1f[n * S + k]); }, epi);
      } else {
        // d_wh0 from dirterm = x_dir (x) wh0; node-table scatter
        for (int h = tid; h < H0; h += kThreads) {
          const float sum = held(gw + q0.wh0 + h, first);
          float acc = 0.0f;
          for (int c = 0; c < 3; ++c)
            for (int r = 0; r < kR; ++r)
              acc += sm.XD[c * kR + r] * sm.DH[h * kLd3 + c * kR + r];
          gw[q0.wh0 + h] = sum + acc;
        }
        for (int i = tid; i < kR * S; i += kThreads) {
          const int r = i / S, s = i - r * S;
          const int jr = sm.JR[r];
          if (jr >= 0) atomicAdd(d_tab_s + static_cast<size_t>(jr) * S + s, sm.DZ[s * kLd + r]);
        }
        for (int i = tid; i < kR * w3; i += kThreads) {
          const int r = i / w3, ch = i - r * w3;  // ch = plane * H0 + h
          const int c = ch / H0, h = ch - c * H0;
          const int jr = sm.JR[r];
          if (jr >= 0)
            atomicAdd(d_tab_v + static_cast<size_t>(jr) * w3 + ch, sm.DH[h * kLd3 + c * kR + r]);
        }
      }
      __syncthreads();
    }
  }
  // a block that got no rows still owns its slice
  if (first)
    for (int i = tid; i < n_w; i += kThreads) gw[i] = 0.0f;
}

// counts[item] = the valid slots (mask set, index in range) of work item
// `item` = b * tiles + tile; a warp an item
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ idx, const float* __restrict__ mask, Dims d,
             int* __restrict__ counts) {
  const int item = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (item >= d.items) return;  // the whole warp
  const int b = item / d.tiles, tile = item - b * d.tiles;
  const int n0 = tile * d.tile_n;
  const int e0 = ((b / d.copies) * d.Nd + n0) * d.K;
  const int slots = min(d.tile_n, d.Nd - n0) * d.K;
  int c = 0;
  for (int s = lane; s < slots; s += 32) {
    const int j = idx[e0 + s];
    c += mask[e0 + s] != 0.0f && j >= 0 && j < d.P;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if (lane == 0) counts[item] = c;
}

// gw[i] += the blocks' slices summed in fp64, in block order
__global__ void __launch_bounds__(kThreads)
sum_slices_kernel(const float* __restrict__ part, int blocks, int n_w, double* __restrict__ gw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_w) return;
  double acc = 0.0;
  for (int b = 0; b < blocks; ++b) acc += static_cast<double>(part[static_cast<size_t>(b) * n_w + i]);
  gw[i] += acc;
}

// Sets the kernel's shared-memory ceiling and returns its persistent grid,
// blocks per SM x SMs but at most one block an item (< 0: a CUDA error).
// The attribute, blocks per SM and the SM count are set or queried once
// (again only for a larger shape or another device), so a launch inside a
// CUDA-graph capture makes no attribute call.
template <typename T, int kR>
int configure(const Dims& d) {
  static size_t configured = 0;
  static int per_sm = 1;
  static int sms[64] = {0};
  auto kern = pp_message_bwd_kernel<T, kR>;
  const size_t smem = smem_floats(d, kR) * sizeof(float);
  cudaError_t e;
  if (smem > configured) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return -static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    configured = smem;
  }
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < 0 || dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return d.items < per_sm * sms[dev] ? d.items : per_sm * sms[dev];
}

template <typename T, int kR>
int launch(const void* tab_s, const void* tab_v, const int* idx, const float* mask,
           const void* rterm, const void* dirterm, const void* rbf, const void* xdir,
           const void* wts, const float* ds, const float* dv, const Dims& d, float* d_tab_s,
           float* d_tab_v, double* gw, float* scratch, long long scratch_floats,
           cudaStream_t stream) {
  const int grid = configure<T, kR>(d);
  if (grid < 0) return -grid;
  const int n_w = grad0_size(d) + (d.n_layers - 1) * gradj_size(d);
  float* const part = scratch;
  int* const counts = reinterpret_cast<int*>(scratch + static_cast<size_t>(grid) * n_w);
  if (static_cast<long long>(grid) * n_w + d.items > scratch_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<(d.items + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      idx, mask, d, counts);
  const size_t smem = smem_floats(d, kR) * sizeof(float);
  pp_message_bwd_kernel<T, kR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(tab_s), static_cast<const T*>(tab_v), idx, mask,
      static_cast<const T*>(rterm), static_cast<const T*>(dirterm), static_cast<const T*>(rbf),
      static_cast<const T*>(xdir), static_cast<const T*>(wts), ds, dv, d, d_tab_s, d_tab_v, counts,
      part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_slices_kernel<<<(n_w + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, grid, n_w,
                                                                              gw);
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int B, int P, int copies, int Nd, int K, int S, int V, int H0, int Hj, int R,
               int n_layers) {
  Dims d;
  d.B = B;
  d.P = P;
  d.copies = copies;
  d.Nd = Nd;
  d.K = K;
  d.S = S;
  d.V = V;
  d.H0 = H0;
  d.Hj = n_layers > 1 ? Hj : 0;
  d.R = R;
  d.n_layers = n_layers;
  d.tile_n = K > 0 ? (kThreads / K < kDests ? kThreads / K : kDests) : 0;
  d.tiles = d.tile_n > 0 ? (Nd + d.tile_n - 1) / d.tile_n : 0;
  d.items = d.tiles * B;
  return d;
}

// the shapes the kernel takes
bool valid(int B, int K, int S, int V, int H0, int Hj, int R, int n_layers) {
  return B > 0 && K >= 1 && K <= 64 && S >= 1 && S <= 128 && V >= 1 && V <= 128 && H0 >= 1 &&
         H0 <= 128 && R >= 1 && R <= 128 && n_layers >= 1 &&
         (n_layers == 1 || (Hj >= 1 && Hj <= 128));
}

}  // namespace

// Dynamic shared memory of one block of the variant that runs at these
// widths, in bytes (of the 16-row variant, above kMaxSmem, where none fits).
extern "C" size_t pp_message_bwd_smem_bytes(int S, int V, int H0, int Hj, int R, int n_layers) {
  const Dims d = make_dims(1, 1, 1, 1, 1, S, V, H0, Hj, R, n_layers);
  const int rows = rows_for(d);
  return smem_floats(d, rows ? rows : 16) * sizeof(float);
}

// Elements of the fp64 weight-gradient buffer (split_weights order).
extern "C" int pp_message_bwd_grads_size(int S, int V, int H0, int Hj, int R, int n_layers) {
  const Dims d = make_dims(1, 1, 1, 1, 1, S, V, H0, Hj, R, n_layers);
  return grad0_size(d) + (n_layers - 1) * gradj_size(d);
}

// The scratch of a launch at these shapes and dtype, in 4-byte words: each
// block's fp32 slice of the weight-gradient sums (the persistent grid x
// pp_message_bwd_grads_size) and the work items' int counts. < 0: minus a
// CUDA error.
extern "C" long long pp_message_bwd_scratch_floats(int bf16, int B, int Nd, int K, int S, int V,
                                                   int H0, int Hj, int R, int n_layers) {
  if (!valid(B, K, S, V, H0, Hj, R, n_layers) || Nd <= 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, 1, 1, Nd, K, S, V, H0, Hj, R, n_layers);
  int grid = -static_cast<int>(cudaErrorInvalidValue);
  switch (rows_for(d) * (bf16 ? -1 : 1)) {
    case 32: grid = configure<float, 32>(d); break;
    case 16: grid = configure<float, 16>(d); break;
    case -32: grid = configure<__nv_bfloat16, 32>(d); break;
    case -16: grid = configure<__nv_bfloat16, 16>(d); break;
  }
  if (grid < 0) return grid;
  return static_cast<long long>(grid) * (grad0_size(d) + (n_layers - 1) * gradj_size(d)) +
         d.items;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0 selects __nv_bfloat16 tables, terms, geometry and weights (else
// float). Pointers (contiguous, current device): tab_s [B,P,S],
// tab_v [B,P,3,H0], idx [G,Nd,K] int32, mask [G,Nd,K] fp32,
// rterm [G,Nd,K,S], dirterm [G,Nd,K,3,H0], rbf [G,Nd,K,R], xdir [G,Nd,K,3],
// wts (packed as for K2), ds [B,Nd,S] fp32, dv [B,Nd,V,3] fp32; outputs,
// zeroed by the caller and accumulated into: d_tab_s [B,P,S],
// d_tab_v [B,P,3,H0] (fp32), gw (pp_message_bwd_grads_size doubles);
// scratch: pp_message_bwd_scratch_floats words (scratch_floats of them).
// B = G * copies; 1 <= K <= 64; S, V, H0, Hj, R <= 128.
extern "C" int pp_message_bwd_launch(int bf16, const void* tab_s, const void* tab_v,
                                     const int* idx, const float* mask, const void* rterm,
                                     const void* dirterm, const void* rbf, const void* xdir,
                                     const void* wts, const float* ds, const float* dv, int B,
                                     int P, int G, int copies, int Nd, int K, int S, int V,
                                     int H0, int Hj, int R, int n_layers, float* d_tab_s,
                                     float* d_tab_v, double* gw, float* scratch,
                                     long long scratch_floats, void* stream) {
  if (B <= 0 || Nd <= 0) return 0;
  if (!valid(B, K, S, V, H0, Hj, R, n_layers) || G * copies != B)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, P, copies, Nd, K, S, V, H0, Hj, R, n_layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = rows_for(d);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kern) {
    return kern(tab_s, tab_v, idx, mask, rterm, dirterm, rbf, xdir, wts, ds, dv, d, d_tab_s,
                d_tab_v, gw, scratch, scratch_floats, st);
  };
  if (bf16)
    return rows == 32 ? go(launch<__nv_bfloat16, 32>) : go(launch<__nv_bfloat16, 16>);
  return rows == 32 ? go(launch<float, 32>) : go(launch<float, 16>);
}
