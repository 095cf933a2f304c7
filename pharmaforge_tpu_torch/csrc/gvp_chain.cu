// A chain of geometric vector perceptrons in one launch (K4).
//
// Replaces no Pallas kernel: the JAX package leaves the GVP to XLA, which
// fuses each chain's products, norms and gates into a few TPU ops. On the
// card the port's PyTorch GVP (models/gvp.py) is ~17 launches a GVP (weight
// casts, two batched products and their copies, the norm's four fp32 ops,
// a concatenation, two addmm, SiLU, sigmoid, the gating product), and a
// full-scale denoiser call runs 21 chains of 2-4 GVPs: about half of the
// step's 1,785 launches, each too small to fill the card. K4 runs a whole
// chain (`GVPChain.forward` without a gradient) as one launch: rows of
// (scalars [R, S_in], vectors [R, V_in, 3]) go through every GVP, and the
// chain's output is written once.
//
// Numerics follow the plain chain (ops/gvp_chain.py::gvp_chain_reference,
// the GVP's PyTorch code) op for op. In the chain's type T every product is
// summed in fp32 and rounded once to T, the bias added before that rounding
// (as addmm does); the channel norms (squares added in order, clamped at
// 1e-8), SiLU (x / (1 + e^-x)) and sigmoid (1 / (1 + e^-x)) run in fp32
// and are rounded to T, as is the gate x vector product. With T = float
// every rounding is the identity. Weights are read in place from the fp32
// parameters and rounded to T as they are staged, so no cast runs per call
// and nothing is cached that an optimizer step could make stale. Rows are
// independent: no atomics, and a call's outputs repeat to the bit.
//
// What bounds it. At the sampling step's shapes (S=128, V=16, pforge-full)
// a GVP is ~22 k multiply-adds a row against ~0.4 kB of a row's inputs and
// outputs for the whole chain, so by the card's peaks every chain is bound
// by operations or bytes in microseconds: the 30,720-row fp32 prot update
// (2 GVPs, 2.7 GFLOP) by the FMA units (40 us at 67 TFLOP/s), the bf16
// message chains by their bytes (the 16,384-row pp chain: 3.7 us at
// 3.35 TB/s), the 960-row chains in 1-2 us. What bounds it in fact is each
// block's fixed work: every block stages every GVP's weights (84 kB of
// fp32 parameters a GVP) from L2, ~10-13 k cycles a GVP, and a GVP is five
// dependent products with an epilogue and a barrier after each, so at one
// or two blocks a SM most of a block's time is latency (PERF.md, section 6).
// The design:
//
// 1. One block a tile of kR rows (16, 32 or 64; the wrapper picks the tile
//    whose waves of blocks cost least, so 960 rows spread over 60 blocks and
//    30,720 go in 64-row tiles), 8 threads a row (four rows a warp in each
//    product) and at least 256. The tile's activations stay in shared
//    memory for the whole chain, as [row][channel] tiles whose row stride is
//    an odd multiple of 16 bytes (conflict-free `ldmatrix` and 16-byte
//    loads). The scalar input and the channel norms share one tile, so the
//    feature product is one sum over S_in + H, as the plain Linear on the
//    concatenation is. Vector products take plane x row as M (3 kR rows).
// 2. Each GVP's weights are staged into shared memory before it runs (bf16:
//    mma fragment order; fp32: [in][out] rows); the products read them from
//    there. A tile of at most 32 rows keeps registers and shared memory for
//    two blocks a SM, so one block's staging overlaps the other's products.
// 3. bf16 products on the tensor cores (mma_bf16.cuh, `mma.sync.m16n8k16`,
//    fp32 accumulators in registers), each warp a 16-row tile; the epilogue
//    rounds where the plain chain stores a bf16 tensor (vh, vu, the norms,
//    the features, the gates, the gated vectors). The tensor cores sum in
//    another order than cuBLAS, so a bf16 output may sit one rounding step
//    from the plain chain's: the card tests state the bound.
// 4. fp32 on the FMA units (TF32 off, as the configurations state): 4 x 4
//    register tiles fed by 16-byte shared-memory loads (1 x 4 for the
//    products at most 16 wide), each sum in k order.
// 5. The feature product overwrites its own input tile: every warp holds
//    its sums in registers across a barrier, then writes.
//
// Limits: at most kMaxLayers GVPs; S_out, V_out and H at most 128 each (one
// register tile a thread); the block's shared memory within kMaxSmem at
// 16 rows. The wrapper (ops/gvp_chain.py) checks them and raises before a
// launch. Registers and spills: the `-Xptxas -v` report in
// build/pharmaforge_tpu_torch/gvp_chain-<hash>.log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;     // S_out, V_out and H of a GVP
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use (Hopper)
constexpr int kDevices = 64;

enum Act { kIdentity = 0, kSilu = 1, kSigmoid = 2 };

// One GVP: pointers to its fp32 parameters as torch holds them, its widths
// and its activations.
struct Layer {
  const float* wh;  // [V_in][H]
  const float* wu;  // [H][U]
  const float* w1;  // [O][S_in + H] (Linear: [out][in])
  const float* b1;  // [O]
  const float* wg;  // [U][O]
  const float* bg;  // [U]
  int v_in, h, u, s_in, o, feats_act, vec_act;
};

struct Chain {
  Layer l[kMaxLayers];
  int n;
};

__host__ __device__ inline int rup(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// round an fp32 value to T and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// PyTorch's fp32 formulas (silu: x / (1 + exp(-x)); sigmoid: 1 / (1 + exp(-x)))
__device__ __forceinline__ float activate(float x, int act) {
  if (act == kSilu) return x / (1.0f + expf(-x));
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-x));
  return x;
}

// ---- shared memory ------------------------------------------------------------
// Row stride (elements) of a [row][channel] tile of c channels: at least c
// padded to 16 (bf16 mma depth) or 4 (fp32 float4 depth), a multiple of 16
// bytes that is odd in 16-byte units.
template <typename T> __host__ __device__ inline int ld_of(int c) {
  const int q = 16 / static_cast<int>(sizeof(T));
  return rup(c, 2 * q) + q;
}
// Row stride of a staged fp32 [kd][n] weight block: n padded to 4, plus 4
// so that a warp staging a transposed source writes 8 banks, not one.
__host__ __device__ inline int wld(int n) { return rup(n, 4) + 4; }
// Elements of a staged [kd][n] weight block: bf16 in mma fragment order
// (multiples of 128), fp32 rows of wld(n) (multiples of 16): 16-byte aligned.
template <typename T> __host__ __device__ inline int wsz(int kd, int n) {
  return sizeof(T) == 2 ? mma_bf16::frag_elems(kd, n) : rup(kd, 4) * wld(n);
}

struct Staged { int wh, wu, w1, wg, size; };
template <typename T> __host__ __device__ inline Staged staged(const Layer& l) {
  Staged s;
  s.wh = 0;
  s.wu = s.wh + wsz<T>(l.v_in, l.h);
  s.w1 = s.wu + wsz<T>(l.h, l.u);
  s.wg = s.w1 + wsz<T>(l.s_in + l.h, l.o);
  s.size = s.wg + wsz<T>(l.o, l.u);
  return s;
}

// Byte offsets of the dynamic shared memory.
struct Smem {
  int ldx, ldg, ldva, ldvh;      // row strides (elements)
  int x, gt, va, vh, act_end;    // activations (T)
  int bias, w, total;            // fp32 biases, staged weights
};

__host__ __device__ inline int take(int& o, long long bytes) {
  const int at = o;
  o += static_cast<int>((bytes + 15) / 16 * 16);
  return at;
}

// X: the scalars with the channel norms after them; GT: the gates; VA: the
// vectors in and out ([plane * kR + row][channel]); VH: the hidden vectors.
template <typename T> __host__ __device__ inline Smem smem_layout(const Chain& c, int kR) {
  int cx = 0, cg = 0, cva = 0, cvh = 0, cb = 0, cw = 0;
  for (int j = 0; j < c.n; ++j) {
    const Layer& l = c.l[j];
    cx = imax(cx, imax(l.s_in + l.h, l.o));
    cg = imax(cg, l.u);
    cva = imax(cva, imax(l.v_in, l.u));
    cvh = imax(cvh, l.h);
    cb = imax(cb, rup(l.o, 4) + rup(l.u, 4));
    cw = imax(cw, staged<T>(l).size);
  }
  const long long es = sizeof(T);
  Smem L;
  L.ldx = ld_of<T>(cx);
  L.ldg = ld_of<T>(cg);
  L.ldva = ld_of<T>(cva);
  L.ldvh = ld_of<T>(cvh);
  int o = 0;
  L.x = take(o, es * kR * L.ldx);
  L.gt = take(o, es * kR * L.ldg);
  L.va = take(o, es * 3 * kR * L.ldva);
  L.vh = take(o, es * 3 * kR * L.ldvh);
  L.act_end = o;
  L.bias = take(o, 4LL * cb);
  L.w = take(o, es * cw);
  L.total = o;
  return L;
}

// ---- staging ------------------------------------------------------------------
// Each GVP's weights go from the fp32 parameters in device memory (L2: every
// block reads the same ones) into the products' layouts, rounded to T. fp32
// needs no rounding, so each element is copied straight to its place with
// `cp.async`: the whole GVP's copies are in flight at once, none held in a
// register. bf16 loads into registers, up to 48 a lane before the first
// store, and rounds. Loads follow the source's contiguous axis, so they
// coalesce, and no index costs a division per element. (Staging takes
// ~10-13 k cycles a GVP either way, a quarter to a half of a block's time:
// PERF.md.)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return mma_bf16::pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// A [kd][n] weight block whose element (k, c) is src[k * sk + c * sc],
// rounded to bf16 into mma fragment order (mma_bf16.cuh: fragment tile =
// nt * KT + kt holds, for lane = 4 g + t, W[kt*16 + 2t + (e&1) +
// 8*(e>>1)][nt*8 + g] at e = 0..3; zeros beyond kd or n). A transposed
// source (sk == 1: a Linear's [out][in] weight) is read kC source rows at a
// time a warp, a lane every 32nd element, and each value is stored alone at
// its place in the fragments; the small [kd][n] sources (Wh, Wu) go a
// fragment tile at a time.
template <int kThreads>
__device__ void stage(const float* __restrict__ src, int sk, int sc, int kd, int n, bf16* dst) {
  constexpr int kWarps = kThreads / 32;
  const int KT = (kd + 15) >> 4, NT = (n + 7) >> 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sk == 1) {
    constexpr int kC = 8, kQ = 6;
    const int kd16 = KT * 16, n8 = NT * 8;
    for (int k0 = 0; k0 < kd16; k0 += 32 * kQ)
      for (int c0 = warp * kC; c0 < n8; c0 += kWarps * kC) {
        float v[kC][kQ];
#pragma unroll
        for (int u = 0; u < kC; ++u)
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int c = c0 + u, k = k0 + lane + 32 * q;
            v[u][q] = c < n && k < kd ? __ldg(src + k + c * sc) : 0.0f;
          }
#pragma unroll
        for (int u = 0; u < kC; ++u)
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int c = c0 + u, k = k0 + lane + 32 * q;
            if (c < n8 && k < kd16) {
              const int tile = (c >> 3) * KT + (k >> 4);
              const int at = ((tile << 5) + 4 * (c & 7) + ((k & 7) >> 1)) * 4 +
                             ((k & 1) | ((k >> 2) & 2));
              dst[at] = __float2bfloat16_rn(v[u][q]);
            }
          }
      }
    return;
  }
  const int t = lane & 3, g = lane >> 2;
  uint2* out = reinterpret_cast<uint2*>(dst);
  for (int tile = warp; tile < KT * NT; tile += kWarps) {
    const int nt = tile / KT, kt = tile - nt * KT;
    const int c = nt * 8 + g;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kt * 16 + 2 * t + (e & 1) + 8 * (e >> 1);
      v[e] = k < kd && c < n ? __ldg(src + k * sk + c * sc) : 0.0f;
    }
    out[tile * 32 + lane] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// The same block as fp32 rows [rup(kd, 4)][wld(n)], zeros in the padding
// rows and columns; a transposed source a source row (c) a warp, lanes
// along k.
template <int kThreads>
__device__ void stage(const float* __restrict__ src, int sk, int sc, int kd, int n, float* dst) {
  constexpr int kWarps = kThreads / 32;
  const int kd4 = rup(kd, 4), ldw = wld(n), n4 = rup(n, 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sk == 1) {
    for (int c = warp; c < n4; c += kWarps)
      for (int k = lane; k < kd4; k += 32) {
        float* d = dst + k * ldw + c;
        if (c < n && k < kd)
          cp_async4(d, src + k + c * sc);
        else
          *d = 0.0f;
      }
    return;
  }
  for (int k = warp; k < kd4; k += kWarps)
    for (int c = lane; c < n4; c += 32) {
      float* d = dst + k * ldw + c;
      if (k < kd && c < n)
        cp_async4(d, src + k * sk + c * sc);
      else
        *d = 0.0f;
    }
}

// Stage GVP `l`'s weights at `w` and its biases (rounded to T) at `bias`:
// b1 at 0, bg at rup(o, 4).
template <typename T, int kThreads>
__device__ void stage_layer(const Layer& l, T* w, float* bias) {
  const Staged s = staged<T>(l);
  stage<kThreads>(l.w1, 1, l.s_in + l.h, l.s_in + l.h, l.o, w + s.w1);
  stage<kThreads>(l.wg, 1, l.o, l.o, l.u, w + s.wg);
  stage<kThreads>(l.wh, l.h, 1, l.v_in, l.h, w + s.wh);
  stage<kThreads>(l.wu, l.u, 1, l.h, l.u, w + s.wu);
  for (int i = threadIdx.x; i < l.o; i += kThreads) bias[i] = rnd<T>(__ldg(l.b1 + i));
  for (int i = threadIdx.x; i < l.u; i += kThreads) bias[rup(l.o, 4) + i] = rnd<T>(__ldg(l.bg + i));
  if (sizeof(T) == 4) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::);
  }
}

// ---- products -----------------------------------------------------------------
// gemm(A, lda, M, W, kd, n, out): for every output of A[M x kd] @ W[kd x n]
// (M a multiple of 16), out(row, col, fp32 sum), by the thread that holds
// it. Channels of A beyond kd (up to the depth's padding) are finite and
// meet zero weight rows.

// bf16: warp tiles of MT x NT mma tiles (16 x 8 each).
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4], const bf16* A, int lda,
                                         const uint2* W, int kt, int n0, int nt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  for (int k = 0; k < kt; ++k) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) mma_bf16::load_a(a[mi], A + mi * 16 * lda + k * 16, lda);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      if (n0 + ni >= nt) break;
      const uint2 b = W[((n0 + ni) * kt + k) * 32 + lane];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_bf16::mma(acc[mi][ni], a[mi], b);
    }
  }
}

template <int MT, int NT, class Out>
__device__ __forceinline__ void mma_out(const float (&acc)[MT][NT][4], int m0, int n0, int n,
                                        const Out& out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
        const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
        if (col < n) out(row, col, acc[mi][ni][e]);
      }
}

template <int kWarps, int MT, int NT, class Out>
__device__ void mma_gemm(const bf16* A, int lda, int M, const uint2* W, int kd, int n,
                         const Out& out) {
  const int kt = (kd + 15) >> 4, nt = (n + 7) >> 3;
  const int tm = M / (16 * MT), tn = (nt + NT - 1) / NT;
  for (int t = threadIdx.x >> 5; t < tm * tn; t += kWarps) {
    const int m0 = (t % tm) * 16 * MT, n0 = (t / tm) * NT;
    float acc[MT][NT][4];
    mma_tile<MT, NT>(acc, A + m0 * lda, lda, W, kt, n0, nt);
    mma_out<MT, NT>(acc, m0, n0, n, out);
  }
}

template <int kThreads, class Out>
__device__ void gemm(const bf16* A, int lda, int M, const bf16* W, int kd, int n,
                     const Out& out) {
  const uint2* w = reinterpret_cast<const uint2*>(W);
  if (n <= 16)
    mma_gemm<kThreads / 32, 1, 1>(A, lda, M, w, kd, n, out);
  else
    mma_gemm<kThreads / 32, 1, 4>(A, lda, M, w, kd, n, out);
}

// fp32: acc[i][u] = sum_k a[i * lda + k] * w[k * ldw + u], k in order: a
// 4 x 4 register tile fed by 16-byte shared-memory loads.
__device__ __forceinline__ void tile4x4(float (&acc)[4][4], const float* a, int lda,
                                        const float* w, int ldw, int kd) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
  for (int k = 0; k < kd; k += 4) {
    float4 av[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = *reinterpret_cast<const float4*>(w + (k + kk) * ldw);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(ai, wv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(ai, wv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(ai, wv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(ai, wv[kk].w, acc[i][3]);
      }
  }
}

template <int kThreads, class Out>
__device__ void gemm(const float* A, int lda, int M, const float* W, int kd, int n,
                     const Out& out) {
  const int ldw = wld(n);
  if (n <= 16) {
    // narrow: one row x 4 columns a thread
    const int row = threadIdx.x >> 2, cg = threadIdx.x & 3;
    if (4 * cg >= n) return;
    for (int r0 = 0; r0 + row < M; r0 += kThreads / 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* a = A + (r0 + row) * lda;
      const float* w = W + 4 * cg;
      for (int k = 0; k < kd; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        float4 wv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wv[kk] = *reinterpret_cast<const float4*>(w + (k + kk) * ldw);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[0] = fmaf(ar[kk], wv[kk].x, acc[0]);
          acc[1] = fmaf(ar[kk], wv[kk].y, acc[1]);
          acc[2] = fmaf(ar[kk], wv[kk].z, acc[2]);
          acc[3] = fmaf(ar[kk], wv[kk].w, acc[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * cg + u < n) out(r0 + row, 4 * cg + u, acc[u]);
    }
  } else {
    // 4 rows a warp, kThreads / 8 rows a pass
    const int rg = threadIdx.x >> 5, cg = threadIdx.x & 31;
    if (4 * cg >= n) return;
    for (int r0 = 0; r0 + 4 * rg < M; r0 += kThreads / 8) {
      float acc[4][4];
      tile4x4(acc, A + (r0 + 4 * rg) * lda, lda, W + 4 * cg, ldw, kd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * cg + u < n) out(r0 + 4 * rg + i, 4 * cg + u, acc[i][u]);
    }
  }
}

// The feature product in place: X[:, :n] <- out(X[:, :kd] @ W1) over the
// tile's kR rows (n <= 128). Each warp holds its sums across a barrier, so
// no thread writes X while another still reads it.
template <int kR, class Out>
__device__ void feats_product(bf16* X, int ldx, const bf16* W, int kd, int n, const Out& out) {
  const int nt = (n + 7) >> 3, tn = (nt + 3) / 4, tm = kR / 16;
  const int t = threadIdx.x >> 5;
  const bool on = t < tm * tn;  // kR / 4 warps, at most tm * 4 tiles
  const int m0 = (t % tm) * 16, n0 = (t / tm) * 4;
  float acc[1][4][4];
  if (on) mma_tile<1, 4>(acc, X + m0 * ldx, ldx, reinterpret_cast<const uint2*>(W), (kd + 15) >> 4,
                         n0, nt);
  __syncthreads();
  if (on) mma_out<1, 4>(acc, m0, n0, n, out);
}

template <int kR, class Out>
__device__ void feats_product(float* X, int ldx, const float* W, int kd, int n, const Out& out) {
  // warp tiles of 8 rows x 64 columns (two lane halves of 4 rows, 16 lanes
  // of 4 columns): a warp's loads of a k step are 4 + 8 wavefronts for 64
  // FMAs a lane; the first kR / 4 warps cover the tile
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 8 * (w >> 1) + 4 * (lane >> 4), c0 = 64 * (w & 1) + 4 * (lane & 15);
  const bool on = w < kR / 4 && c0 < n;
  float acc[4][4];
  if (on) tile4x4(acc, X + r0 * ldx, ldx, W + c0, wld(n), kd);
  __syncthreads();
  if (!on) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < n) out(r0 + i, c0 + u, acc[i][u]);
}

// X[r][c0 + c] = |VH[plane][r][c]| over the three planes for c < h: fp32,
// the squares added in the plain chain's order without contraction, the
// square clamped below at 1e-8 (NaN passes, as torch.clamp lets it).
template <typename T, int kR, int kThreads>
__device__ void channel_norms(const T* VH, int ldvh, T* X, int ldx, int c0, int h) {
  for (int i = threadIdx.x; i < h * kR; i += kThreads) {
    const int r = i / h, c = i - r * h;
    const float x = to_f(VH[r * ldvh + c]), y = to_f(VH[(kR + r) * ldvh + c]),
                z = to_f(VH[(2 * kR + r) * ldvh + c]);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    X[r * ldx + c0 + c] = from_f<T>(sqrtf(sq < 1e-8f ? 1e-8f : sq));
  }
}

// ---- the kernel ---------------------------------------------------------------
// Threads of a kR-row block: 8 a row (four rows a warp in every product),
// and at least 256, so that a small tile's staging has lanes enough. Tiles
// of up to 32 rows keep registers for two blocks a SM.
__host__ __device__ constexpr int threads_of(int kR) { return kR * 8 > 256 ? kR * 8 : 256; }

template <typename T, int kR>
__global__ void __launch_bounds__(threads_of(kR), kR <= 32 ? 2 : 1)
gvp_chain_kernel(const T* __restrict__ s_in, const T* __restrict__ v_in, int rows, Chain c,
                 Smem L, T* __restrict__ s_out, T* __restrict__ v_out) {
  constexpr int kThreads = threads_of(kR);
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  T* X = reinterpret_cast<T*>(sm + L.x);
  T* GT = reinterpret_cast<T*>(sm + L.gt);
  T* VA = reinterpret_cast<T*>(sm + L.va);
  T* VH = reinterpret_cast<T*>(sm + L.vh);
  float* BIAS = reinterpret_cast<float*>(sm + L.bias);
  T* W = reinterpret_cast<T*>(sm + L.w);
  const int ldx = L.ldx, ldg = L.ldg, ldva = L.ldva, ldvh = L.ldvh;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kR;
  const int nr = rows - row0 < kR ? static_cast<int>(rows - row0) : kR;

  // zero the activations (rows past the end and padding channels stay
  // finite), then the tile's inputs
  for (int i = tid; i < L.act_end / 16; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  {
    constexpr int kBatch = 8;
    const int s0 = c.l[0].s_in, w0 = 3 * c.l[0].v_in;
    const T* src_s = s_in + row0 * s0;
    const T* src_v = v_in + row0 * w0;
    for (int i0 = tid; i0 < nr * s0; i0 += kBatch * kThreads) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * kThreads < nr * s0) v[u] = src_s[i0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nr * s0) {
          const int r = i / s0;
          X[r * ldx + i - r * s0] = v[u];
        }
      }
    }
    for (int i0 = tid; i0 < nr * w0; i0 += kBatch * kThreads) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * kThreads < nr * w0) v[u] = src_v[i0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nr * w0) {
          const int r = i / w0, q = i - r * w0, ch = q / 3, p = q - 3 * ch;
          VA[(p * kR + r) * ldva + ch] = v[u];
        }
      }
    }
  }

  for (int j = 0; j < c.n; ++j) {
    const Layer& l = c.l[j];
    const Staged s = staged<T>(l);
    stage_layer<T, kThreads>(l, W, BIAS);
    __syncthreads();
    // vh = VA @ Wh
    gemm<kThreads>(VA, ldva, 3 * kR, W + s.wh, l.v_in, l.h,
                   [=](int r, int col, float acc) { VH[r * ldvh + col] = from_f<T>(acc); });
    __syncthreads();
    // sh = |vh| beside the scalars
    channel_norms<T, kR, kThreads>(VH, ldvh, X, ldx, l.s_in, l.h);
    __syncthreads();
    // feats = act(cat(scalars, sh) @ W1^T + b1)
    const int fa = l.feats_act;
    feats_product<kR>(X, ldx, W + s.w1, l.s_in + l.h, l.o, [=](int r, int col, float acc) {
      X[r * ldx + col] = from_f<T>(activate(rnd<T>(acc + BIAS[col]), fa));
    });
    __syncthreads();
    // gates = act(feats @ Wg^T + bg)
    const int va = l.vec_act, ob = rup(l.o, 4);
    gemm<kThreads>(X, ldx, kR, W + s.wg, l.o, l.u, [=](int r, int col, float acc) {
      GT[r * ldg + col] = from_f<T>(activate(rnd<T>(acc + BIAS[ob + col]), va));
    });
    __syncthreads();
    // vectors = gates x (vh @ Wu)
    gemm<kThreads>(VH, ldvh, 3 * kR, W + s.wu, l.h, l.u, [=](int r, int col, float acc) {
      VA[r * ldva + col] = from_f<T>(to_f(GT[(r & (kR - 1)) * ldg + col]) * rnd<T>(acc));
    });
    __syncthreads();
  }

  const int so = c.l[c.n - 1].o, wo = 3 * c.l[c.n - 1].u;
  T* dst_s = s_out + row0 * so;
  T* dst_v = v_out + row0 * wo;
  for (int i = tid; i < nr * so; i += kThreads) {
    const int r = i / so;
    dst_s[i] = X[r * ldx + i - r * so];
  }
  for (int i = tid; i < nr * wo; i += kThreads) {
    const int r = i / wo, q = i - r * wo, ch = q / 3, p = q - 3 * ch;
    dst_v[i] = VA[(p * kR + r) * ldva + ch];
  }
}

// The chain's layers from the C interface's arrays; 0 if they are out of
// the kernel's limits or do not chain.
int make_chain(int n_layers, const int* dims, const void* const* weights, Chain& c) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  c.n = n_layers;
  for (int j = 0; j < n_layers; ++j) {
    Layer& l = c.l[j];
    const int* d = dims + 7 * j;
    const void* const* w = weights + 6 * j;
    l.v_in = d[0];
    l.h = d[1];
    l.u = d[2];
    l.s_in = d[3];
    l.o = d[4];
    l.feats_act = d[5];
    l.vec_act = d[6];
    l.wh = static_cast<const float*>(w[0]);
    l.wu = static_cast<const float*>(w[1]);
    l.w1 = static_cast<const float*>(w[2]);
    l.b1 = static_cast<const float*>(w[3]);
    l.wg = static_cast<const float*>(w[4]);
    l.bg = static_cast<const float*>(w[5]);
    if (l.v_in < 1 || l.h < 1 || l.u < 1 || l.s_in < 1 || l.o < 1 || l.h > kMaxWidth ||
        l.u > kMaxWidth || l.o > kMaxWidth || l.feats_act < 0 || l.feats_act > 2 ||
        l.vec_act < 0 || l.vec_act > 2)
      return 0;
    if (j > 0 && (l.s_in != c.l[j - 1].o || l.v_in != c.l[j - 1].u)) return 0;
  }
  return 1;
}

template <typename T, int kR>
int launch(const void* s_in, const void* v_in, int rows, const Chain& c, void* s_out,
           void* v_out, cudaStream_t stream) {
  // the shared-memory ceiling is raised once per device (again only for a
  // larger chain), so a launch inside a CUDA-graph capture makes no
  // attribute call
  static int configured[kDevices] = {0};
  const Smem L = smem_layout<T>(c, kR);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  auto kern = gvp_chain_kernel<T, kR>;
  if (L.total > configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = L.total;
  }
  const int grid = (rows + kR - 1) / kR;
  kern<<<grid, threads_of(kR), L.total, stream>>>(static_cast<const T*>(s_in), static_cast<const T*>(v_in),
                                          rows, c, L, static_cast<T*>(s_out),
                                          static_cast<T*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int rows_per_block, const void* s_in, const void* v_in, int rows, const Chain& c,
                void* s_out, void* v_out, cudaStream_t stream) {
  if (rows_per_block == 64) return launch<T, 64>(s_in, v_in, rows, c, s_out, v_out, stream);
  if (rows_per_block == 32) return launch<T, 32>(s_in, v_in, rows, c, s_out, v_out, stream);
  if (rows_per_block == 16) return launch<T, 16>(s_in, v_in, rows, c, s_out, v_out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one block (bytes) for a chain of `n_layers` GVPs
// whose widths are dims[7 * j + (0..4)] = (V_in, H, V_out, S_in, S_out) and
// activations dims[7 * j + (5, 6)] (0 identity, 1 SiLU, 2 sigmoid), at
// `rows_per_block` rows in bf16 (bf16 != 0) or fp32; 0 where the chain is
// out of the kernel's limits. ops/gvp_chain.py::smem_bytes mirrors it.
extern "C" long long gvp_chain_smem_bytes(int bf16, int rows_per_block, int n_layers,
                                          const int* dims) {
  static const void* const none[6 * kMaxLayers] = {nullptr};
  Chain c;
  if (!make_chain(n_layers, dims, none, c)) return 0;
  return bf16 ? smem_layout<__nv_bfloat16>(c, rows_per_block).total
              : smem_layout<float>(c, rows_per_block).total;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0 selects __nv_bfloat16 activations (else float); weights are fp32
// in either case. Pointers (contiguous, current device): s_in [rows, S_in],
// v_in [rows, V_in, 3], s_out [rows, S_out], v_out [rows, V_out, 3] of the
// chain's first and last GVP; weights[6 * j + (0..5)] = GVP j's Wh [V_in, H],
// Wu [H, V_out], the feature Linear's weight [S_out, S_in + H] and bias, the
// gate Linear's weight [V_out, S_out] and bias. rows_per_block: 16, 32 or 64.
extern "C" int gvp_chain_launch(int bf16, int rows_per_block, const void* s_in, const void* v_in,
                                int rows, int n_layers, const int* dims,
                                const void* const* weights, void* s_out, void* v_out,
                                void* stream) {
  Chain c;
  if (!make_chain(n_layers, dims, weights, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_rows<__nv_bfloat16>(rows_per_block, s_in, v_in, rows, c, s_out, v_out, st);
  return launch_rows<float>(rows_per_block, s_in, v_in, rows, c, s_out, v_out, st);
}
