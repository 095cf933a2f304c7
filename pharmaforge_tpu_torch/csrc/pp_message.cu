// Fused prot-prot message chain + masked K-sum for the sampling chain's
// middle convolutions (K2).
//
// Replaces the Pallas TPU kernel pharmaforge_tpu/ops/pallas/pp_message.py
// (`_kernel`, launched by `_pallas_impl`). For every batch row b and
// destination atom n it gathers the K source rows idx[g, n, :] (g = b /
// copies: the edge descriptors are kept once per pocket group) of the
// per-copy node tables pre_s [B,P,S] and vh [B,P,3,H0], adds the
// group-level edge terms rterm [G,Nd,K,S] and dirterm [G,Nd,K,3,H0], runs
// the message GVP chain on each of the K edge rows and returns the masked
// sums s_sum [B,Nd,S] and v_sum [B,Nd,V,3] in fp32.
//
// Numerics follow the plain version (ops/pp_message.py::_chain_plain) op
// for op: every product is accumulated in fp32 and rounded once to the
// compute type T; the adds that the plain version does in T are rounded to
// T; channel norms (clamped at 1e-8), SiLU and sigmoid run in fp32 and are
// rounded to T; the masked K-sum is fp32, each destination's rows added in
// k order (no atomics: two calls give bit-equal sums). With T = float
// every rounding is the identity. A slot whose index lies outside [0, P)
// counts as masked.
//
// What bounds it. At the sampling shape (B=120, Nd=P=230, K=16, S=128,
// V=16, H0=17, three message GVPs) only the ~17% of slots whose mask is set
// need the chain: ~75 k edge rows x 2 x 49 k multiply-adds = 7.4 GFLOP
// against ~35 MB of inputs and outputs, so the card's bound is bytes
// (10.4 us at 3.35 TB/s; the bf16 tensor cores need 7.5 us, the fp32 FMA
// units 110 us). The work is ~13 small products per edge row (N from 16 to
// 128, depth 16 to 144), each feeding an epilogue that the next reads, so
// what costs time is latency: barriers, per-block fixed work, the
// epilogues' transcendentals and the on-chip traffic between stages, not
// the products' peak rate. The design:
//
// 1. Persistent blocks. The grid is blocks-per-SM x SMs (both queried once
//    and cached), 512 threads a block. Each block takes the work items
//    item = blockIdx.x + i * gridDim.x (batch row fastest, so neighbouring
//    blocks share a pocket group's edge terms in L2) with a static stride:
//    no global work counter. In bf16 the whole chain's weights (97 KB) are
//    staged into shared memory once per block and stay resident; in fp32
//    they are 187 KB and do not fit beside the activations, so each GVP's
//    weights are staged once per 64-row chunk (not once per product). A
//    bf16 chain whose resident weights would not fit (5 or more GVPs at
//    the sampling widths: each adds 42 KB) is staged per GVP the same way.
// 2. Full chunks. A work item is min(64, 256 / K) destinations of one batch
//    row; a block prefix sum compacts its valid slots in slot order into a
//    ring of rows, so each destination's rows
//    stay contiguous and in k order. The block's items stream through the
//    ring: every chunk takes the next 64 rows across item boundaries, so
//    only the block's last chunk is partial, and small items keep the
//    blocks' shares even. A destination may straddle two chunks: its sum so
//    far is carried in shared memory to the next chunk, and each sum is
//    written once, when its last row has been added.
// 3. bf16 products on the tensor cores (mma_bf16.cuh): activations live in
//    shared memory as bf16 [row][channel] tiles (exact: the plain version
//    rounds every stage to bf16) with a row stride of an odd multiple of
//    16 bytes, so `ldmatrix` is free of bank conflicts; weights are staged
//    in mma fragment order, depths zero-padded to 16 and widths to 8; every
//    product is `mma.sync.m16n8k16` with fp32 accumulators in registers and
//    its epilogue (rounding, bias, SiLU, sigmoid, gate x vector) applied to
//    the accumulator fragments, loads first. The vector products take
//    plane x row as M (3 x 64 = 192 rows). The tensor cores sum in another
//    order than the plain version's GEMM; a sum within kTieUlps of a
//    bf16 rounding midpoint is summed again in k order (near_tie), which
//    keeps the bf16 outputs within a third of the tolerance. Not
//    `wgmma`/TMA: with products this small and an epilogue after each, a
//    64-row warpgroup pipeline pays only once the kernel is within a few
//    times of its bound.
// 4. fp32 stays on the FMA units (TF32 keeps ~3 digits, and the fp32
//    tolerance is rtol 1e-5): the same [row][channel] tiles in fp32, each
//    thread a 4-row x 4-column (or 1 x 4 for the V-wide products) register
//    tile fed by 16-byte shared-memory loads.
// 5. Vector gathers: node-table and edge-term rows are read 16 bytes a
//    thread where the width allows (S a multiple of 8 in bf16, 4 in fp32,
//    16-byte aligned tables), the 3*H0-wide vector rows a warp a row; every
//    load of a thread is issued before its first store, with no integer
//    division per element.
//
// Budget at the sampling widths (S=128, V=16, H0=17, Hj=16, 3 GVPs), 512
// threads, one block per SM: bf16 159,088 bytes of dynamic shared memory
// (weights 97,280; activations 50,176; ring, runs, carries and biases
// 11,632), fp32 178,544 (one GVP's weights 83,968; activations 82,944);
// both under the 232,448 bytes a Hopper block may opt into (kMaxSmem).
// Registers and spills: the `-Xptxas -v` report in
// build/pharmaforge_tpu_torch/pp_message-<hash>.log, quoted in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // edge rows per chunk
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDests = 64;     // the most destinations a work item holds
constexpr int kItemSlots = 256;  // the most slots a work item scans
constexpr int kRing = 512;     // compacted rows a block holds: < kRows + kItemSlots
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use (Hopper)
static_assert(kRows == 64, "a chunk's run scan takes two rows a lane");

__host__ __device__ inline int rup(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int pad8(int n) { return rup(n, 8); }
__host__ __device__ inline size_t rup16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

// fp32 -> T (rounds to nearest even for bf16)
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// round an fp32 value to T and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// 1 / (1 + e^-x) as the plain version computes it: __frcp_rn is the
// correctly rounded reciprocal, the same value as the division 1.0f / y
__device__ __forceinline__ float sigmoid_f(float x) { return __frcp_rn(1.0f + expf(-x)); }

// The tensor cores add a product's terms in another order (and with other
// intermediate rounding) than the plain version's fp32 GEMM, which sums
// sequentially in k. Where such a sum lies within kTieUlps fp32 ulps of a
// bf16 rounding midpoint the two could round to different bf16 neighbours,
// so that element is summed again on the FMA units in k order. About
// 2 * kTieUlps / 65536 of the elements take this path. With 16 ulps the
// sampling shape's and the compact tail's bf16 errors are 0.35 and 0.05 of
// PP_TOL (8 ulps: 0.35 and 0.18; none: 0.90 and 1.40, beyond it), for
// about a fifth of the bf16 time (PERF.md).
constexpr int kTieUlps = 16;

__device__ __forceinline__ bool near_tie(float x) {
  const int low = static_cast<int>(__float_as_uint(x) & 0xffffu);
  return abs(low - 0x8000) <= kTieUlps;
}

// sum_k A[row][k] * W[k][col] in k order, W in mma fragment order
// (mma_bf16::stage_fragments, KT k-tiles)
__device__ __noinline__ float exact_dot(const bf16* A, int lda, int row, const uint2* W, int KT,
                                        int col) {
  // k and k + 1 (k even) are adjacent in both A and W: 32-bit loads. The
  // depth's zero padding adds exact zeros.
  const uint32_t* a = reinterpret_cast<const uint32_t*>(A + row * lda);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(W) + ((col >> 3) * KT * 32 + (col & 7) * 4) * 2;
  float s = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t av[8], wv[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      av[p] = a[kt * 8 + p];
      wv[p] = w[kt * 64 + (p & 3) * 2 + (p >> 2)];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      s = fmaf(mma_bf16::lo_f(av[p]), mma_bf16::lo_f(wv[p]), s);
      s = fmaf(mma_bf16::hi_f(av[p]), mma_bf16::hi_f(wv[p]), s);
    }
  }
  return s;
}

struct Dims {
  int B, P, copies, Nd, K, S, V, H0, Hj, n_layers, tile_n, tiles, items;
  int vec;  // node tables and rterm take 16-byte loads
};

// Offsets (in elements) of each weight inside the packed buffer; every
// block starts on a multiple of 8 elements. Must match
// ops/pp_message.py::_pack_weights.
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

// ---- staged weights ---------------------------------------------------------
// bf16: mma fragment order (mma_bf16::stage_fragments); fp32: [kd][n]
// row-major with both padded to 4, zeros in the padding. Sizes in elements,
// each a multiple of 128 (bf16) or 16 (fp32), so every block is 16-byte
// aligned.
template <typename T> __host__ __device__ inline int wsz(int kd, int n) {
  return sizeof(T) == 2 ? mma_bf16::frag_elems(kd, n) : rup(kd, 4) * rup(n, 4);
}
struct Staged0 { int w1sh, wg, wu, size; };
struct StagedJ { int wh, wu, w1f, w1sh, wg, size; };
template <typename T> __host__ __device__ inline Staged0 staged0(const Dims& d) {
  Staged0 o;
  o.w1sh = 0;
  o.wg = o.w1sh + wsz<T>(d.H0, d.S);
  o.wu = o.wg + wsz<T>(d.S, d.V);
  o.size = o.wu + wsz<T>(d.H0, d.V);
  return o;
}
template <typename T> __host__ __device__ inline StagedJ stagedj(const Dims& d) {
  StagedJ o;
  o.wh = 0;
  o.wu = o.wh + wsz<T>(d.V, d.Hj);
  o.w1f = o.wu + wsz<T>(d.Hj, d.V);
  o.w1sh = o.w1f + wsz<T>(d.S, d.S);
  o.wg = o.w1sh + wsz<T>(d.Hj, d.S);
  o.size = o.wg + wsz<T>(d.S, d.V);
  return o;
}
// fp32 biases: GVP 0's bg, then each later GVP's (b1, bg), each padded to 4
__host__ __device__ inline int bias_j(const Dims& d, int j) {
  return rup(d.V, 4) + (j - 1) * (rup(d.S, 4) + rup(d.V, 4));
}

// Row stride (elements) of a [row][channel] tile of C channels: a multiple
// of 16 bytes that is odd in 16-byte units, so the 8 rows one ldmatrix (or
// 8 threads' 16-byte loads) touch fall in distinct banks; at least the
// channels padded to 16 (bf16 mma depth) or 4 (fp32 float4 depth).
template <typename T> __host__ __device__ inline int ld_of(int c) {
  const int q = 16 / static_cast<int>(sizeof(T));
  return rup(c, 2 * q) + q;
}

// Byte offsets of the dynamic shared memory.
struct Smem {
  int ld_s, ld_h, ld_v;                         // row strides (elements)
  int fs, sh, gt, vh, vc, act_end;              // activations (T)
  int ml, tr, el, dr, ds, ws, rs, cdr, cs, cv, bias, w, total;
  int resident;  // every GVP's weights staged once per block (else per chunk)
};

__host__ __device__ inline int take(int& o, size_t bytes) {
  const int at = o;
  o += static_cast<int>(rup16(bytes));
  return at;
}

template <typename T> __host__ __device__ inline Smem smem_layout(const Dims& d) {
  Smem L;
  const int es = sizeof(T), Hm = d.H0 > d.Hj ? d.H0 : d.Hj;
  L.ld_s = ld_of<T>(d.S);
  L.ld_h = ld_of<T>(Hm);
  L.ld_v = ld_of<T>(d.V);
  int o = 0;
  L.fs = take(o, static_cast<size_t>(kRows) * L.ld_s * es);     // scalar features
  L.sh = take(o, static_cast<size_t>(kRows) * L.ld_h * es);     // channel norms
  L.gt = take(o, static_cast<size_t>(kRows) * L.ld_v * es);     // gates
  L.vh = take(o, static_cast<size_t>(3 * kRows) * L.ld_h * es); // hidden vectors
  L.vc = take(o, static_cast<size_t>(3 * kRows) * L.ld_v * es); // output vectors
  L.act_end = o;
  L.ml = take(o, kRing * 4);                                    // compacted rows:
  L.tr = take(o, kRing * 4);                                    // mask, table row,
  L.el = take(o, kRing * 4);                                    // edge slot,
  L.dr = take(o, kRing * 4);                                    // output row
  L.ds = take(o, (kDests + 1) * 4);                             // first row per dest
  L.ws = take(o, 64 * 4);                                       // scan scratch
  L.rs = take(o, (kRows + 2) * 4);                              // runs of a chunk
  L.cdr = take(o, 2 * 4);                                       // carried sums:
  L.cs = take(o, static_cast<size_t>(2) * d.S * 4);             // output row,
  L.cv = take(o, static_cast<size_t>(2) * 3 * d.V * 4);         // scalar, vector
  L.bias = take(o, static_cast<size_t>(bias_j(d, d.n_layers)) * 4);
  // bf16 keeps the whole chain resident where it fits; fp32 (and a bf16
  // chain too deep to fit) holds one GVP's weights at a time
  const int w0 = staged0<T>(d).size, wj = d.n_layers > 1 ? stagedj<T>(d).size : 0;
  const size_t chain = static_cast<size_t>(w0) + static_cast<size_t>(d.n_layers - 1) * wj;
  L.w = o;
  L.resident = sizeof(T) == 2 && L.w + rup16(chain * es) <= static_cast<size_t>(kMaxSmem);
  take(o, (L.resident ? chain : static_cast<size_t>(w0 > wj ? w0 : wj)) * es);
  L.total = o;
  return L;
}

// Stage one [kd][n] weight block (packed row-major in global memory).
__device__ void stage_mat(const bf16* src, int kd, int n, unsigned char* dst) {
  mma_bf16::stage_fragments(src, kd, n, reinterpret_cast<bf16*>(dst), threadIdx.x, kThreads);
}
__device__ void stage_mat(const float* src, int kd, int n, unsigned char* dst) {
  float* w = reinterpret_cast<float*>(dst);
  const int ldw = rup(n, 4), kd4 = rup(kd, 4);
  if (ldw == n && kd4 == kd) {
    // packed blocks start on 8-element boundaries: 16-byte copies
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(w);
    const int n4 = kd * n / 4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < n4) v[u] = s4[i0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < n4) d4[i0 + u * kThreads] = v[u];
    }
    return;
  }
  for (int i = threadIdx.x; i < kd4 * ldw; i += kThreads) {
    const int k = i / ldw, c = i - k * ldw;
    w[i] = k < kd && c < n ? src[k * n + c] : 0.0f;
  }
}

// Stage GVP `layer`'s weight blocks at `dst`.
template <typename T>
__device__ void stage_layer(const T* __restrict__ wts, const Dims& d, int layer,
                            unsigned char* dst) {
  const int es = sizeof(T);
  if (layer == 0) {
    const Layer0 o = layer0_offsets(d);
    const Staged0 s = staged0<T>(d);
    stage_mat(wts + o.w1_sh, d.H0, d.S, dst + es * s.w1sh);
    stage_mat(wts + o.wg, d.S, d.V, dst + es * s.wg);
    stage_mat(wts + o.wu, d.H0, d.V, dst + es * s.wu);
  } else {
    const LayerJ o = layerj_offsets(d, layer);
    const StagedJ s = stagedj<T>(d);
    stage_mat(wts + o.wh, d.V, d.Hj, dst + es * s.wh);
    stage_mat(wts + o.wu, d.Hj, d.V, dst + es * s.wu);
    stage_mat(wts + o.w1f, d.S, d.S, dst + es * s.w1f);
    stage_mat(wts + o.w1sh, d.Hj, d.S, dst + es * s.w1sh);
    stage_mat(wts + o.wg, d.S, d.V, dst + es * s.wg);
  }
}

// ---- products -----------------------------------------------------------------
// gemm(A, lda, M, W, kd, n, epi): out = A[M x kd] @ W[kd x n] over M rows
// (a multiple of 64) of a [row][channel] tile, by the thread that holds
// each output: x = epi.in(row, col) for every output of the thread first,
// then epi.out(row, col, fp32 sum, x), so the epilogue's loads are all in
// flight before its first store (the compiler cannot prove that a store to
// a tile leaves the next load alone). Channels of A beyond kd are finite
// and meet zero weight rows.
template <class In, class Out>
struct Epilogue {
  In in;
  Out out;
};
template <class In, class Out>
__device__ __forceinline__ Epilogue<In, Out> epilogue(In in, Out out) {
  return {in, out};
}

// bf16: warp tiles of MT x NT mma tiles (16 x 8 each), strided over warps.
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

// Sums near a bf16 rounding midpoint taken again in k order (near_tie).
template <int MT, int NT>
__device__ __forceinline__ void fix_ties(float (&acc)[MT][NT][4], const bf16* A, int lda,
                                         int m0, const uint2* W, int kd, int n0, int n) {
  const int lane = threadIdx.x & 31, kt = (kd + 15) >> 4;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
        const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
        if (col < n && near_tie(acc[mi][ni][e]))
          acc[mi][ni][e] = exact_dot(A, lda, row, W, kt, col);
      }
}

template <int MT, int NT, class Epi>
__device__ __forceinline__ void mma_epilogue(const float (&acc)[MT][NT][4], int m0, int n0,
                                             int n, const Epi& epi) {
  const int lane = threadIdx.x & 31;
  float x[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
        const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
        x[mi][ni][e] = col < n ? epi.in(row, col) : 0.0f;
      }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
        const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
        if (col < n) epi.out(row, col, acc[mi][ni][e], x[mi][ni][e]);
      }
}

template <int MT, int NT, class Epi>
__device__ void mma_gemm(const bf16* A, int lda, int M, const uint2* W, int kd, int n,
                         const Epi& epi) {
  const int kt = (kd + 15) >> 4, nt = (n + 7) >> 3;
  const int tm = M / (16 * MT), tn = (nt + NT - 1) / NT;
  for (int t = threadIdx.x >> 5; t < tm * tn; t += kWarps) {
    const int m0 = (t % tm) * 16 * MT, n0 = (t / tm) * NT;
    float acc[MT][NT][4];
    mma_tile<MT, NT>(acc, A + m0 * lda, lda, W, kt, n0, nt);
    fix_ties<MT, NT>(acc, A, lda, m0, W, kd, n0, n);
    mma_epilogue<MT, NT>(acc, m0, n0, n, epi);
  }
}

template <class Epi>
__device__ void gemm(const bf16* A, int lda, int M, const unsigned char* W, int kd, int n,
                     const Epi& epi) {
  const uint2* w = reinterpret_cast<const uint2*>(W);
  if (n <= 16)
    mma_gemm<1, 1>(A, lda, M, w, kd, n, epi);
  else
    mma_gemm<1, 4>(A, lda, M, w, kd, n, epi);
}

// fp32: acc[i][u] = sum_k A[4*rg + i][k] * W[k][4*cg + u] (rg = tid / 32,
// cg = tid % 32): 64 rows x up to 128 columns; a warp shares its four A
// rows (broadcast loads) and reads 32 consecutive W float4s.
__device__ __forceinline__ void tile_wide(float (&acc)[4][4], const float* A, int lda,
                                          const float* W, int kd, int n) {
  const int rg = threadIdx.x >> 5, cg = threadIdx.x & 31;
  const int ldw = rup(n, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
  if (4 * cg >= n) return;
  const float* a = A + 4 * rg * lda;
  const float* w = W + 4 * cg;
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

template <class Epi>
__device__ __forceinline__ void for_wide(const float (&acc)[4][4], int r0, int n,
                                         const Epi& epi) {
  const int rg = threadIdx.x >> 5, cg = threadIdx.x & 31;
  float x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[i][u] = 4 * cg + u < n ? epi.in(r0 + 4 * rg + i, 4 * cg + u) : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * cg + u < n) epi.out(r0 + 4 * rg + i, 4 * cg + u, acc[i][u], x[i][u]);
}

template <class Epi>
__device__ void gemm(const float* A, int lda, int M, const unsigned char* Wb, int kd, int n,
                     const Epi& epi) {
  const float* W = reinterpret_cast<const float*>(Wb);
  if (n <= 16) {
    // narrow: one row x 4 columns a thread, 128 rows a pass
    const int row = threadIdx.x >> 2, cg = threadIdx.x & 3;
    if (4 * cg >= n) return;
    const int ldw = rup(n, 4);
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
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = 4 * cg + u < n ? epi.in(r0 + row, 4 * cg + u) : 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * cg + u < n) epi.out(r0 + row, 4 * cg + u, acc[u], x[u]);
    }
  } else {
    for (int r0 = 0; r0 < M; r0 += kRows) {
      float acc[4][4];
      tile_wide(acc, A + r0 * lda, lda, W, kd, n);
      for_wide(acc, r0, n, epi);
    }
  }
}

// Scalar update of a layer j >= 1 over the chunk's 64 rows:
// FS <- silu(rnd(rnd(FS @ W1f) + rnd(SH @ W1sh)) + b1), both products held
// in registers until every thread has read FS.
template <class Epi2>
__device__ void feats_products(const bf16* FS, int lds, const bf16* SH, int ldh,
                               const unsigned char* W1f, const unsigned char* W1sh, int S,
                               int Hj, const Epi2& epi) {
  // M = 64 rows as 4 m-tiles, N = S <= 128 as at most 4 groups of 4
  // n-tiles: at most 16 warp tiles, one a warp
  const int nt = (S + 7) >> 3, tn = (nt + 3) / 4;
  const int t = threadIdx.x >> 5;
  const bool on = t < 4 * tn;
  const int m0 = (t % 4) * 16, n0 = (t / 4) * 4;
  float a1[1][4][4], a2[1][4][4];
  if (on) {
    const uint2* w1 = reinterpret_cast<const uint2*>(W1f);
    const uint2* w2 = reinterpret_cast<const uint2*>(W1sh);
    mma_tile<1, 4>(a1, FS + m0 * lds, lds, w1, (S + 15) >> 4, n0, nt);
    mma_tile<1, 4>(a2, SH + m0 * ldh, ldh, w2, (Hj + 15) >> 4, n0, nt);
    fix_ties<1, 4>(a1, FS, lds, m0, w1, S, n0, S);
    fix_ties<1, 4>(a2, SH, ldh, m0, w2, Hj, n0, S);
  }
  __syncthreads();
  if (!on) return;
  const int lane = threadIdx.x & 31;
  float x[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + (lane >> 2) + 8 * (e >> 1);
      const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
      x[ni][e] = col < S ? epi.in(row, col) : 0.0f;
    }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + (lane >> 2) + 8 * (e >> 1);
      const int col = (n0 + ni) * 8 + 2 * (lane & 3) + (e & 1);
      if (col < S) epi.out(row, col, a1[0][ni][e], a2[0][ni][e], x[ni][e]);
    }
}

template <class Epi2>
__device__ void feats_products(const float* FS, int lds, const float* SH, int ldh,
                               const unsigned char* W1f, const unsigned char* W1sh, int S,
                               int Hj, const Epi2& epi) {
  float a1[4][4], a2[4][4];
  tile_wide(a1, FS, lds, reinterpret_cast<const float*>(W1f), S, S);
  tile_wide(a2, SH, ldh, reinterpret_cast<const float*>(W1sh), Hj, S);
  __syncthreads();
  const int rg = threadIdx.x >> 5, cg = threadIdx.x & 31;
  float x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) x[i][u] = 4 * cg + u < S ? epi.in(4 * rg + i, 4 * cg + u) : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * cg + u < S) epi.out(4 * rg + i, 4 * cg + u, a1[i][u], a2[i][u], x[i][u]);
}

// SH[r][h] = |VH[plane][r][h]| over the three planes, fp32, clamped; the
// squares are added in the plain version's order, without contraction.
template <typename T>
__device__ void channel_norms(const T* VH, T* SH, int ld, int h) {
  for (int i = threadIdx.x; i < h * kRows; i += kThreads) {
    const int r = i / h, c = i - r * h;
    const float x = to_f(VH[r * ld + c]), y = to_f(VH[(kRows + r) * ld + c]),
                z = to_f(VH[(2 * kRows + r) * ld + c]);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    SH[r * ld + c] = from_f<T>(sqrtf(fmaxf(sq, 1e-8f)));
  }
}

// Exclusive prefix sum of `flag` over the block; ws[kWarps] gets the sum.
__device__ int block_scan(int flag, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = ws[w];
      ws[w] = run;
      run += c;
    }
    ws[kWarps] = run;
  }
  __syncthreads();
  return ws[warp] + x - flag;
}

// 16 bytes of T: fp32 a + b rounded to T, element-wise
template <typename T>
__device__ __forceinline__ uint4 add_rnd(uint4 x, uint4 y) {
  constexpr int q = 16 / sizeof(T);
  const T* xa = reinterpret_cast<const T*>(&x);
  const T* ya = reinterpret_cast<const T*>(&y);
  uint4 out;
  T* oa = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int u = 0; u < q; ++u) oa[u] = from_f<T>(to_f(xa[u]) + to_f(ya[u]));
  return out;
}

// The chunk's rows head .. head + nr - 1 of the ring of compacted rows
// (rows beyond nr are zero): FS[r][s] = tab_s[b, j] + rterm[slot],
// VH[plane][r][h] = tab_v[b, j, plane, h] + dirterm[slot, plane, h],
// rounded to T; TR holds b * P + j and EL the slot.
__device__ __forceinline__ int ring(int i) { return i & (kRing - 1); }

template <typename T>
__device__ void gather(T* FS, T* VH, const Smem& L, const T* __restrict__ tab_s,
                       const T* __restrict__ tab_v, const T* __restrict__ rterm,
                       const T* __restrict__ dirterm, const int* TR, const int* EL, int head,
                       int nr, const Dims& d) {
  const int S = d.S, H0 = d.H0, w3 = 3 * H0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (d.vec) {
    // every load of the thread issued before its first store
    constexpr int q = 16 / sizeof(T);
    constexpr int kIt = kRows * 128 / q / kThreads;  // S <= 128
    const int nv = S / q;
    uint4 x[kIt], y[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / nv, c = (i - r * nv) * q;
      x[it] = y[it] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kRows * nv && r < nr) {
        const size_t t = TR[ring(head + r)], e = EL[ring(head + r)];
        x[it] = *reinterpret_cast<const uint4*>(tab_s + t * S + c);
        y[it] = *reinterpret_cast<const uint4*>(rterm + e * S + c);
      }
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / nv, c = (i - r * nv) * q;
      if (i < kRows * nv)
        *reinterpret_cast<uint4*>(FS + r * L.ld_s + c) =
            r < nr ? add_rnd<T>(x[it], y[it]) : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int r = warp; r < kRows; r += kWarps) {
      const bool on = r < nr;
      const T* ts = on ? tab_s + static_cast<size_t>(TR[ring(head + r)]) * S : nullptr;
      const T* rt = on ? rterm + static_cast<size_t>(EL[ring(head + r)]) * S : nullptr;
      for (int s = lane; s < S; s += 32)
        FS[r * L.ld_s + s] = from_f<T>(on ? to_f(ts[s]) + to_f(rt[s]) : 0.0f);
    }
  }
  // vector rows: a warp takes rows warp, warp + 8, ..., and loads a
  // channel of all its 8 rows before it stores any
  constexpr int kRw = kRows / kWarps;
  const T* tv[kRw];
  const T* dt[kRw];
#pragma unroll
  for (int it = 0; it < kRw; ++it) {
    const int r = warp + it * kWarps;
    tv[it] = r < nr ? tab_v + static_cast<size_t>(TR[ring(head + r)]) * w3 : nullptr;
    dt[it] = r < nr ? dirterm + static_cast<size_t>(EL[ring(head + r)]) * w3 : nullptr;
  }
  for (int ch = lane; ch < w3; ch += 32) {
    const int c = ch >= H0 ? (ch >= 2 * H0 ? 2 : 1) : 0, h = ch - c * H0;
    float v[kRw];
#pragma unroll
    for (int it = 0; it < kRw; ++it) v[it] = tv[it] ? to_f(tv[it][ch]) + to_f(dt[it][ch]) : 0.0f;
#pragma unroll
    for (int it = 0; it < kRw; ++it)
      VH[(c * kRows + warp + it * kWarps) * L.ld_h + h] = from_f<T>(v[it]);
  }
}

// kResident: every GVP's weights are staged once per block (bf16 chains
// that fit); else each GVP's once per chunk.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
pp_message_kernel(const T* __restrict__ tab_s, const T* __restrict__ tab_v,
                  const int* __restrict__ idx, const float* __restrict__ mask,
                  const T* __restrict__ rterm, const T* __restrict__ dirterm,
                  const T* __restrict__ wts, Dims d, Smem L, float* __restrict__ s_out,
                  float* __restrict__ v_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  T* FS = reinterpret_cast<T*>(sm + L.fs);
  T* SH = reinterpret_cast<T*>(sm + L.sh);
  T* GT = reinterpret_cast<T*>(sm + L.gt);
  T* VH = reinterpret_cast<T*>(sm + L.vh);
  T* VC = reinterpret_cast<T*>(sm + L.vc);
  float* ML = reinterpret_cast<float*>(sm + L.ml);
  int* TR = reinterpret_cast<int*>(sm + L.tr);
  int* EL = reinterpret_cast<int*>(sm + L.el);
  int* DR = reinterpret_cast<int*>(sm + L.dr);
  int* DS = reinterpret_cast<int*>(sm + L.ds);
  int* WS = reinterpret_cast<int*>(sm + L.ws);
  int* RS = reinterpret_cast<int*>(sm + L.rs);
  int* CDR = reinterpret_cast<int*>(sm + L.cdr);
  float* CS = reinterpret_cast<float*>(sm + L.cs);
  float* CV = reinterpret_cast<float*>(sm + L.cv);
  float* BIAS = reinterpret_cast<float*>(sm + L.bias);
  unsigned char* WB = sm + L.w;

  const int S = d.S, V = d.V, H0 = d.H0, Hj = d.Hj, K = d.K, TN = d.tile_n;
  const int lds = L.ld_s, ldh = L.ld_h, ldv = L.ld_v;
  const int tid = threadIdx.x;
  const int es = sizeof(T);
  const Staged0 s0 = staged0<T>(d);
  const StagedJ sj = stagedj<T>(d);
  // staged weights of GVP `layer`
  auto wl = [&](int layer) -> unsigned char* {
    return kResident && layer > 0 ? WB + es * (s0.size + (layer - 1) * sj.size) : WB;
  };

  // ---- once per block: zero the activations (padding channels stay zero,
  // so products over padded depths read finite values), stage the biases
  // and, where resident, every GVP's weights
  for (int i = tid; i < L.act_end / 16; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const Layer0 o = layer0_offsets(d);
    for (int i = tid; i < V; i += kThreads) BIAS[i] = to_f(wts[o.bg + i]);
    for (int j = 1; j < d.n_layers; ++j) {
      const LayerJ oj = layerj_offsets(d, j);
      float* bj = BIAS + bias_j(d, j);
      for (int i = tid; i < S; i += kThreads) bj[i] = to_f(wts[oj.b1 + i]);
      for (int i = tid; i < V; i += kThreads) bj[rup(S, 4) + i] = to_f(wts[oj.bg + i]);
    }
  }
  if (kResident)
    for (int j = 0; j < d.n_layers; ++j) stage_layer(wts, d, j, wl(j));
  if (tid == 0) CDR[0] = -1;  // no sums carried into the first chunk
  __syncthreads();

  // output vectors: gate x (hidden vectors @ Wu), rows plane * 64 + r
  const auto gated = epilogue(
      [&](int row, int c) { return to_f(GT[(row & (kRows - 1)) * ldv + c]); },
      [&](int row, int c, float acc, float x) { VC[row * ldv + c] = from_f<T>(x * rnd<T>(acc)); });

  // Append work item `item`'s valid slots (mask set, index in range) to the
  // ring at `tail`, in slot order, and write zeros for its destinations
  // that have none; returns how many it appended.
  const int slots = TN * K, w_out = S + 3 * V;
  int scans = 0;
  auto compact = [&](int item, int tail) -> int {
    const int b = item % d.B, tile = item / d.B;
    const int g = b / d.copies, n0 = tile * TN;
    const int e0 = (g * d.Nd + n0) * K;  // first slot
    const int nl = tid / K;
    int flag = 0, j = -1;
    float m = 0.0f;
    if (tid < slots && n0 + nl < d.Nd) {
      j = idx[e0 + tid];
      m = mask[e0 + tid];
      flag = m != 0.0f && j >= 0 && j < d.P;
    }
    int* ws = WS + 32 * (scans++ & 1);  // scans alternate scratch
    const int pos = block_scan(flag, ws);
    const int n_valid = ws[kWarps];
    if (flag) {
      const int q = ring(tail + pos);
      ML[q] = m;
      TR[q] = b * d.P + j;
      EL[q] = e0 + tid;
      DR[q] = b * d.Nd + n0 + nl;
    }
    if (tid < slots && tid == nl * K) DS[nl] = pos;
    if (tid == 0) DS[TN] = n_valid;
    __syncthreads();
    for (int i = tid; i < TN * w_out; i += kThreads) {
      const int n = i / w_out, c = i - n * w_out;
      if (n0 + n < d.Nd && DS[n] == DS[n + 1]) {
        const size_t row = static_cast<size_t>(b) * d.Nd + n0 + n;
        if (c < S)
          s_out[row * S + c] = 0.0f;
        else
          v_out[row * 3 * V + c - S] = 0.0f;
      }
    }
    return n_valid;
  };

  // The block's items (item = blockIdx.x + i * gridDim.x, batch row
  // fastest) stream through the ring: each chunk takes the next 64 rows,
  // across item boundaries, so only the block's last chunk is partial.
  int head = 0, tail = 0, next = blockIdx.x;
  for (int chunk = 0;; ++chunk) {
    while (tail - head < kRows && next < d.items) {
      tail += compact(next, tail);
      next += gridDim.x;
    }
    const int avail = tail - head;
    if (avail == 0) break;
    const int nr = min(kRows, avail);
    gather<T>(FS, VH, L, tab_s, tab_v, rterm, dirterm, TR, EL, head, nr, d);
    if (!kResident) stage_layer(wts, d, 0, WB);
    if (tid < 32) {
      // the chunk's runs of rows of one destination: RS[i] is the first row
      // of run i, RS[n_runs] = nr, RS[kRows + 1] = n_runs
      const int lane = tid;
      auto starts = [&](int r) {
        return r < nr && (r == 0 || DR[ring(head + r)] != DR[ring(head + r - 1)]);
      };
      const bool s1 = starts(lane), s2 = starts(lane + 32);
      const unsigned b1 = __ballot_sync(0xffffffffu, s1), b2 = __ballot_sync(0xffffffffu, s2);
      const unsigned below = (1u << lane) - 1u;
      if (s1) RS[__popc(b1 & below)] = lane;
      if (s2) RS[__popc(b1) + __popc(b2 & below)] = lane + 32;
      if (lane == 0) {
        RS[__popc(b1) + __popc(b2)] = nr;
        RS[kRows + 1] = __popc(b1) + __popc(b2);
      }
    }
    __syncthreads();

    // ---- message GVP 0 -----------------------------------------------------
    {
      const unsigned char* W = wl(0);
      channel_norms<T>(VH, SH, ldh, H0);
      __syncthreads();
      gemm(SH, ldh, kRows, W + es * s0.w1sh, H0, S,
           epilogue([&](int r, int c) { return to_f(FS[r * lds + c]); },
                    [&](int r, int c, float acc, float x) {
                      const float z = rnd<T>(x + rnd<T>(acc));
                      FS[r * lds + c] = from_f<T>(z * sigmoid_f(z));
                    }));
      __syncthreads();
      gemm(FS, lds, kRows, W + es * s0.wg, S, V,
           epilogue([&](int r, int c) { return BIAS[c]; },
                    [&](int r, int c, float acc, float x) {
                      GT[r * ldv + c] = from_f<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + x)));
                    }));
      __syncthreads();
      gemm(VH, ldh, 3 * kRows, W + es * s0.wu, H0, V, gated);
      __syncthreads();
    }

    // ---- message GVPs 1 .. n-1 ---------------------------------------------
    for (int layer = 1; layer < d.n_layers; ++layer) {
      if (!kResident) {
        stage_layer(wts, d, layer, WB);
        __syncthreads();
      }
      const unsigned char* W = wl(layer);
      const float* bj = BIAS + bias_j(d, layer);
      gemm(VC, ldv, 3 * kRows, W + es * sj.wh, V, Hj,
           epilogue([&](int r, int c) { return 0.0f; },
                    [&](int r, int c, float acc, float) { VH[r * ldh + c] = from_f<T>(acc); }));
      __syncthreads();
      channel_norms<T>(VH, SH, ldh, Hj);
      __syncthreads();
      feats_products(FS, lds, SH, ldh, W + es * sj.w1f, W + es * sj.w1sh, S, Hj,
                     epilogue([&](int r, int c) { return bj[c]; },
                              [&](int r, int c, float a1, float a2, float x) {
                                const float z = rnd<T>(rnd<T>(rnd<T>(a1) + rnd<T>(a2)) + x);
                                FS[r * lds + c] = from_f<T>(z * sigmoid_f(z));
                              }));
      __syncthreads();
      gemm(FS, lds, kRows, W + es * sj.wg, S, V,
           epilogue([&](int r, int c) { return bj[rup(S, 4) + c]; },
                    [&](int r, int c, float acc, float x) {
                      GT[r * ldv + c] = from_f<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + x)));
                    }));
      __syncthreads();
      gemm(VH, ldh, 3 * kRows, W + es * sj.wu, Hj, V, gated);
      __syncthreads();
    }

    // ---- masked sums: a destination's rows are contiguous; the thread of
    // its first row in the chunk adds them in k order to the sum carried
    // from the chunk before (if it started there) and writes the result,
    // or carries it on when the destination goes on into the next chunk
    const int par = chunk & 1, carried = CDR[par];
    const int last = DR[ring(head + nr - 1)];
    const bool cont = nr < avail && DR[ring(head + nr)] == last;
    const float* cs_in = CS + par * S;
    const float* cv_in = CV + par * 3 * V;
    float* cs_out = CS + (par ^ 1) * S;
    float* cv_out = CV + (par ^ 1) * 3 * V;
    const int n_runs = RS[kRows + 1];
    for (int i = tid; i < n_runs * S; i += kThreads) {
      const int run = i / S, s = i - run * S;
      const int r0 = RS[run], r1 = RS[run + 1];
      const int dr = DR[ring(head + r0)];
      float acc = r0 == 0 && dr == carried ? cs_in[s] : 0.0f;
      for (int p = r0; p < r1; ++p) acc += to_f(FS[p * lds + s]) * ML[ring(head + p)];
      if (r1 == nr && cont)
        cs_out[s] = acc;
      else
        s_out[static_cast<size_t>(dr) * S + s] = acc;
    }
    const int w3v = 3 * V;
    for (int i = tid; i < n_runs * w3v; i += kThreads) {
      const int run = i / w3v, q = i - run * w3v;  // q = v * 3 + plane
      const int v = q / 3, c = q - v * 3;
      const int r0 = RS[run], r1 = RS[run + 1];
      const int dr = DR[ring(head + r0)];
      float acc = r0 == 0 && dr == carried ? cv_in[q] : 0.0f;
      for (int p = r0; p < r1; ++p)
        acc += to_f(VC[(c * kRows + p) * ldv + v]) * ML[ring(head + p)];
      if (r1 == nr && cont)
        cv_out[q] = acc;
      else
        v_out[static_cast<size_t>(dr) * w3v + q] = acc;
    }
    if (tid == 0) CDR[par ^ 1] = cont ? last : -1;
    head += nr;
    __syncthreads();
  }
}

Dims make_dims(int B, int P, int copies, int Nd, int K, int S, int V, int H0, int Hj,
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
  d.n_layers = n_layers;
  d.tile_n = K > 0 ? (kItemSlots / K < kDests ? kItemSlots / K : kDests) : 0;
  d.tiles = d.tile_n > 0 ? (Nd + d.tile_n - 1) / d.tile_n : 0;
  d.items = d.tiles * B;
  d.vec = 0;
  return d;
}

template <typename T>
int launch(const void* tab_s, const void* tab_v, const int* idx, const float* mask,
           const void* rterm, const void* dirterm, const void* wts, Dims d, float* s_out,
           float* v_out, cudaStream_t stream) {
  // each kernel's shared-memory ceiling, blocks per SM and the SM count
  // are set or queried once (again only for a larger shape or another
  // device), so a launch inside a CUDA-graph capture makes no attribute call
  static int configured[2] = {0, 0}, per_sm[2] = {1, 1};
  static int sms[64] = {0};
  const Smem L = smem_layout<T>(d);
  const int r = L.resident;
  auto kern = pp_message_kernel<T, false>;
  if constexpr (sizeof(T) == 2)
    if (r) kern = pp_message_kernel<T, true>;
  if (L.total > configured[r]) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[r], kern, kThreads, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm[r] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    configured[r] = L.total;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int q = 16 / sizeof(T);
  d.vec = d.S % q == 0 &&
          ((reinterpret_cast<uintptr_t>(tab_s) | reinterpret_cast<uintptr_t>(rterm)) & 15) == 0;
  const int slots = per_sm[r] * sms[dev];
  const int grid = d.items < slots ? d.items : slots;
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(tab_s), static_cast<const T*>(tab_v), idx, mask,
      static_cast<const T*>(rterm), static_cast<const T*>(dirterm), static_cast<const T*>(wts), d,
      L, s_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements of the packed weight buffer (see ops/pp_message.py).
extern "C" int pp_message_weights_size(int S, int V, int H0, int Hj, int n_layers) {
  const Dims d = make_dims(1, 1, 1, 1, 1, S, V, H0, Hj, n_layers);
  return layer0_size(d) + (n_layers - 1) * layerj_size(d);
}

// Dynamic shared memory of one block of the bf16 (bf16 != 0) or fp32
// kernel, in bytes.
extern "C" size_t pp_message_smem_bytes(int bf16, int S, int V, int H0, int Hj, int n_layers) {
  const Dims d = make_dims(1, 1, 1, 1, 1, S, V, H0, Hj, n_layers);
  return static_cast<size_t>(bf16 ? smem_layout<__nv_bfloat16>(d).total
                                  : smem_layout<float>(d).total);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0 selects __nv_bfloat16 tables, terms and weights (else float).
// Pointers (contiguous, current device): tab_s [B,P,S], tab_v [B,P,3,H0],
// idx [G,Nd,K] int32, mask [G,Nd,K] fp32, rterm [G,Nd,K,S],
// dirterm [G,Nd,K,3,H0], wts (packed), s_out [B,Nd,S] fp32,
// v_out [B,Nd,V,3] fp32. B = G * copies; 1 <= K <= 64; S <= 128;
// V, H0, Hj <= 128.
extern "C" int pp_message_launch(int bf16, const void* tab_s, const void* tab_v, const int* idx,
                                 const float* mask, const void* rterm, const void* dirterm,
                                 const void* wts, int B, int P, int G, int copies, int Nd, int K,
                                 int S, int V, int H0, int Hj, int n_layers, float* s_out,
                                 float* v_out, void* stream) {
  if (B <= 0 || Nd <= 0) return 0;
  if (K < 1 || K > kRows || S < 1 || S > 128 || V < 1 || V > 128 || H0 < 1 || H0 > 128 ||
      n_layers < 1 || (n_layers > 1 && (Hj < 1 || Hj > 128)) || G * copies != B)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, P, copies, Nd, K, S, V, H0, Hj, n_layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(tab_s, tab_v, idx, mask, rterm, dirterm, wts, d, s_out, v_out,
                                 st);
  return launch<float>(tab_s, tab_v, idx, mask, rterm, dirterm, wts, d, s_out, v_out, st);
}
