// Fused prot-prot message chain + masked K-sum for the sampling chain's
// middle convolutions.
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
// rounded to T; the masked K-sum is fp32. With T = float every rounding is
// the identity.
//
// Bound: at the sampling shape (B=120, Nd=P=230, K=16, S=128, V=16, three
// message GVPs) the chain does ~49 k multiply-adds per edge row, ~43 GFLOP
// a call if every one of the 441,600 slots were an edge; but the pp lists
// are sparse (3.5 A cutoff, padded atoms), and only the slots whose mask
// is set need the chain: 17% of them on synthetic pockets, 7.4 GFLOP
// against ~35 MB of inputs and outputs (PERF.md). This first version runs
// the products on the fp32 FMA units (no tensor cores). The design keeps
// every per-edge activation on chip and spends work only on valid slots:
// one block owns a tile of 256 / K destinations (at most 64) of one batch
// row, compacts the tile's valid slots with a block prefix sum (in slot
// order, so each destination's rows stay contiguous and in k order), and
// runs the chain on them in chunks of 64 rows. A chunk's activations live
// in shared memory as [channel][row] fp32 columns, each layer's weights
// are staged in shared memory, and every product is a register tile
// (4 rows x 8 columns a thread for the S-wide products, 1 row x 4 columns
// for the V-wide ones). Each chunk adds its rows into the tile's
// per-destination sums in shared memory, which the block writes once: no
// atomics, no second pass. The TPU kernel's one-hot gather matrix,
// lane-packed block-diagonal weights and padded tiles are not carried
// over: rows are read with indexed loads and the ragged edges are masked
// in the kernel. A slot whose index lies outside [0, P) counts as masked
// (it reads nothing and adds zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;             // edge rows per chunk
constexpr int kThreads = 256;         // also the most slots a tile holds
constexpr int kDests = 64;            // the most destinations a tile holds
constexpr int kLd = kRows + 4;        // row stride of [channel][row] tiles
constexpr int kLd3 = 3 * kRows + 4;   // same for the 3-plane vector tiles

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

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

struct Dims {
  int P, copies, Nd, K, S, V, H0, Hj, n_layers, tile_n, tiles;
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

// Stage a [kd][n] weight block (T, row-major) into shared memory as fp32
// with row stride round4(n), zero-padding the extra columns.
template <typename T>
__device__ void stage(const T* __restrict__ src, int kd, int n, float* dst) {
  const int ldw = round4(n);
  if (ldw == n) {
    for (int i = threadIdx.x; i < kd * n; i += kThreads) dst[i] = to_f(src[i]);
  } else {
    for (int i = threadIdx.x; i < kd * ldw; i += kThreads) {
      const int k = i / ldw, c = i - k * ldw;
      dst[i] = c < n ? to_f(src[k * n + c]) : 0.0f;
    }
  }
}

// acc[i][4g+u] = sum_k A[k][r0 + 4*rg + i] * W[k][64g + 4*cg + u]
// (rg = tid / 16, cg = tid % 16): 64 rows x up to 64*NG columns.
template <int NG>
__device__ __forceinline__ void tile_wide(float (&acc)[4][4 * NG], const float* A, int lda,
                                          const float* W, int kd, int n) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int ldw = round4(n);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.0f;
  if (4 * cg >= n) return;
  const bool hi = NG > 1 && 64 + 4 * cg < n;
  const float* a = A + 4 * rg;
  const float* w = W + 4 * cg;
#pragma unroll 4
  for (int k = 0; k < kd; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g == 1 && !hi) break;
      const float4 wv = *reinterpret_cast<const float4*>(w + k * ldw + 64 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * g + 0] = fmaf(ar[i], wv.x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(ar[i], wv.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(ar[i], wv.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(ar[i], wv.w, acc[i][4 * g + 3]);
      }
    }
  }
}

template <int NG, class Epi>
__device__ __forceinline__ void for_wide(const float (&acc)[4][4 * NG], int r0, int n, Epi epi) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 64 * g + 4 * cg + u;
        if (c < n) epi(r0 + 4 * rg + i, c, acc[i][4 * g + u]);
      }
}

// out = A[rows, kd] @ W[kd, n] over `rows` (a multiple of 64) rows; epi(row,
// col, fp32 sum) runs once per output. A is [kd][lda] fp32 in shared memory.
template <class Epi>
__device__ void gemm(const float* A, int lda, int rows, const float* W, int kd, int n, Epi epi) {
  if (n <= 16) {
    // narrow: one row x 4 columns a thread
    const int row = threadIdx.x >> 2, cg = threadIdx.x & 3;
    if (4 * cg >= n) return;
    const int ldw = round4(n);
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* a = A + r0 + row;
      const float* w = W + 4 * cg;
#pragma unroll 4
      for (int k = 0; k < kd; ++k) {
        const float av = a[k * lda];
        const float4 wv = *reinterpret_cast<const float4*>(w + k * ldw);
        acc[0] = fmaf(av, wv.x, acc[0]);
        acc[1] = fmaf(av, wv.y, acc[1]);
        acc[2] = fmaf(av, wv.z, acc[2]);
        acc[3] = fmaf(av, wv.w, acc[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * cg + u < n) epi(r0 + row, 4 * cg + u, acc[u]);
    }
  } else if (n <= 64) {
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[4][4];
      tile_wide<1>(acc, A + r0, lda, W, kd, n);
      for_wide<1>(acc, r0, n, epi);
    }
  } else {
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[4][8];
      tile_wide<2>(acc, A + r0, lda, W, kd, n);
      for_wide<2>(acc, r0, n, epi);
    }
  }
}

// Scalar update of a layer j >= 1: FS <- silu((FS @ W1f + SH @ W1sh) + b1),
// with both products held in registers until every thread has read FS.
template <typename T, int NG>
__device__ void feats_update(float* FS, const float* SH, const float* W1f, const float* W1sh,
                             const T* __restrict__ b1, int S, int Hj) {
  float a1[4][4 * NG], a2[4][4 * NG];
  tile_wide<NG>(a1, FS, kLd, W1f, S, S);
  tile_wide<NG>(a2, SH, kLd, W1sh, Hj, S);
  __syncthreads();
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 64 * g + 4 * cg + u;
        if (c < S) {
          const float z = rnd<T>(rnd<T>(rnd<T>(a1[i][4 * g + u]) + rnd<T>(a2[i][4 * g + u])) +
                                 to_f(b1[c]));
          FS[c * kLd + 4 * rg + i] = rnd<T>(z * sigmoid_f(z));
        }
      }
}

// SH[h][r] = |VH[h][plane c][r]| over the three planes, fp32, clamped.
template <typename T>
__device__ void channel_norms(const float* VH, float* SH, int h) {
  for (int i = threadIdx.x; i < h * kRows; i += kThreads) {
    const int c = i / kRows, r = i - c * kRows;
    const float* v = VH + c * kLd3 + r;
    const float x = v[0], y = v[kRows], z = v[2 * kRows];
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pp_message_kernel(const T* __restrict__ tab_s, const T* __restrict__ tab_v,
                  const int* __restrict__ idx, const float* __restrict__ mask,
                  const T* __restrict__ rterm, const T* __restrict__ dirterm,
                  const T* __restrict__ wts, Dims d, float* __restrict__ s_out,
                  float* __restrict__ v_out) {
  extern __shared__ float4 smem4[];
  const int S = d.S, V = d.V, H0 = d.H0, Hj = d.Hj, K = d.K, TN = d.tile_n;
  const int Hm = H0 > Hj ? H0 : Hj;
  float* FS = reinterpret_cast<float*>(smem4);  // [S][kLd] scalar features
  float* SH = FS + S * kLd;                      // [Hm][kLd] channel norms
  float* GT = SH + Hm * kLd;                     // [V][kLd] gates
  float* VH = GT + V * kLd;                      // [Hm][kLd3] hidden vectors
  float* VC = VH + Hm * kLd3;                    // [V][kLd3] output vectors
  float* AS = VC + V * kLd3;                     // [TN][S] scalar sums
  float* AV = AS + TN * S;                       // [TN][3V] vector sums
  float* MR = AS + round4(TN * (S + 3 * V));     // [kRows] chunk: slot mask
  int* JR = reinterpret_cast<int*>(MR + kRows);  // [kRows] chunk: source index
  int* ER = JR + kRows;                          // [kRows] chunk: edge slot
  float* ML = reinterpret_cast<float*>(ER + kRows);  // [kThreads] valid slots
  int* JL = reinterpret_cast<int*>(ML + kThreads);   // (mask, source, slot)
  int* SL = JL + kThreads;
  int* DS = SL + kThreads;                       // [kDests + 1] first row of
  int* WS = DS + kDests + 4;                     // each destination; scan
  float* W = reinterpret_cast<float*>(WS + 12);  // staged weights

  const int b = blockIdx.y, tile = blockIdx.x;
  const int g = b / d.copies;
  const int n0 = tile * TN;
  const int tid = threadIdx.x;
  const size_t e0 = (static_cast<size_t>(g) * d.Nd + n0) * K;  // first slot

  // ---- compact the tile's valid slots (mask set, index in range) ----------
  // in slot order, so each destination's rows stay contiguous and in k order
  int flag = 0, j = -1;
  float m = 0.0f;
  if (tid < TN * K && n0 + tid / K < d.Nd) {
    j = idx[e0 + tid];
    m = mask[e0 + tid];
    flag = m != 0.0f && j >= 0 && j < d.P;
  }
  const int pos = block_scan(flag, WS, WS + 8);
  const int n_valid = WS[8];
  if (flag) {
    ML[pos] = m;
    JL[pos] = j;
    SL[pos] = tid;
  }
  if (tid < TN * K && tid % K == 0) DS[tid / K] = pos;
  if (tid == 0) DS[TN] = n_valid;
  for (int i = tid; i < TN * S; i += kThreads) AS[i] = 0.0f;
  for (int i = tid; i < TN * 3 * V; i += kThreads) AV[i] = 0.0f;
  __syncthreads();

  const Layer0 o0 = layer0_offsets(d);
  const size_t tab_row0 = static_cast<size_t>(b) * d.P;
  const int w3 = 3 * H0;
  for (int c0 = 0; c0 < n_valid; c0 += kRows) {
    // ---- this chunk's rows: gather + group-level terms -----------------------
    for (int r = tid; r < kRows; r += kThreads) {
      const bool on = c0 + r < n_valid;
      MR[r] = on ? ML[c0 + r] : 0.0f;
      JR[r] = on ? JL[c0 + r] : -1;
      ER[r] = on ? SL[c0 + r] : -1;
    }
    __syncthreads();
    for (int i = tid; i < kRows * S; i += kThreads) {
      const int r = i / S, s = i - r * S;
      const int jr = JR[r];
      FS[s * kLd + r] = jr >= 0 ? rnd<T>(to_f(tab_s[(tab_row0 + jr) * S + s]) +
                                         to_f(rterm[(e0 + ER[r]) * S + s]))
                                : 0.0f;
    }
    for (int i = tid; i < kRows * w3; i += kThreads) {
      const int r = i / w3, ch = i - r * w3;  // ch = plane * H0 + h
      const int c = ch / H0, h = ch - c * H0;
      const int jr = JR[r];
      VH[h * kLd3 + c * kRows + r] =
          jr >= 0 ? rnd<T>(to_f(tab_v[(tab_row0 + jr) * w3 + ch]) +
                           to_f(dirterm[(e0 + ER[r]) * w3 + ch]))
                  : 0.0f;
    }
    __syncthreads();

    // ---- message GVP 0 -----------------------------------------------------
    channel_norms<T>(VH, SH, H0);
    stage(wts + o0.w1_sh, H0, S, W);
    __syncthreads();
    gemm(SH, kLd, kRows, W, H0, S, [&](int r, int c, float acc) {
      const float z = rnd<T>(FS[c * kLd + r] + rnd<T>(acc));
      FS[c * kLd + r] = rnd<T>(z * sigmoid_f(z));
    });
    __syncthreads();
    stage(wts + o0.wg, S, V, W);
    __syncthreads();
    gemm(FS, kLd, kRows, W, S, V, [&](int r, int c, float acc) {
      GT[c * kLd + r] = rnd<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + to_f(wts[o0.bg + c]))));
    });
    __syncthreads();
    stage(wts + o0.wu, H0, V, W);
    __syncthreads();
    gemm(VH, kLd3, 3 * kRows, W, H0, V, [&](int row, int c, float acc) {
      VC[c * kLd3 + row] = rnd<T>(GT[c * kLd + row % kRows] * rnd<T>(acc));
    });
    __syncthreads();

    // ---- message GVPs 1 .. n-1 ---------------------------------------------
    for (int layer = 1; layer < d.n_layers; ++layer) {
      const LayerJ o = layerj_offsets(d, layer);
      stage(wts + o.wh, V, Hj, W);
      __syncthreads();
      gemm(VC, kLd3, 3 * kRows, W, V, Hj,
           [&](int row, int c, float acc) { VH[c * kLd3 + row] = rnd<T>(acc); });
      __syncthreads();
      channel_norms<T>(VH, SH, Hj);
      float* W2 = W + S * round4(S);
      stage(wts + o.w1f, S, S, W);
      stage(wts + o.w1sh, Hj, S, W2);
      __syncthreads();
      if (S <= 64)
        feats_update<T, 1>(FS, SH, W, W2, wts + o.b1, S, Hj);
      else
        feats_update<T, 2>(FS, SH, W, W2, wts + o.b1, S, Hj);
      __syncthreads();
      stage(wts + o.wg, S, V, W);
      __syncthreads();
      gemm(FS, kLd, kRows, W, S, V, [&](int r, int c, float acc) {
        GT[c * kLd + r] = rnd<T>(sigmoid_f(rnd<T>(rnd<T>(acc) + to_f(wts[o.bg + c]))));
      });
      __syncthreads();
      stage(wts + o.wu, Hj, V, W);
      __syncthreads();
      gemm(VH, kLd3, 3 * kRows, W, Hj, V, [&](int row, int c, float acc) {
        VC[c * kLd3 + row] = rnd<T>(GT[c * kLd + row % kRows] * rnd<T>(acc));
      });
      __syncthreads();
    }

    // ---- masked sum of this chunk's rows into their destinations -------------
    // (rows of one destination are contiguous; summed in k order across chunks)
    for (int i = tid; i < TN * S; i += kThreads) {
      const int nl = i / S, s = i - nl * S;
      const int lo = max(DS[nl], c0), hi = min(DS[nl + 1], c0 + kRows);
      float acc = AS[i];
      for (int p = lo; p < hi; ++p) acc += FS[s * kLd + p - c0] * MR[p - c0];
      AS[i] = acc;
    }
    for (int i = tid; i < TN * 3 * V; i += kThreads) {
      const int nl = i / (3 * V), q = i - nl * 3 * V;  // q = v * 3 + plane
      const int v = q / 3, c = q - v * 3;
      const int lo = max(DS[nl], c0), hi = min(DS[nl + 1], c0 + kRows);
      float acc = AV[i];
      for (int p = lo; p < hi; ++p) acc += VC[v * kLd3 + c * kRows + p - c0] * MR[p - c0];
      AV[i] = acc;
    }
    __syncthreads();
  }

  // ---- write the tile's destinations once ------------------------------------
  const size_t out_row0 = static_cast<size_t>(b) * d.Nd + n0;
  const int rows_out = min(TN, d.Nd - n0);
  for (int i = tid; i < rows_out * S; i += kThreads) s_out[out_row0 * S + i] = AS[i];
  for (int i = tid; i < rows_out * 3 * V; i += kThreads) v_out[out_row0 * 3 * V + i] = AV[i];
}

size_t smem_floats(const Dims& d) {
  const int Hm = d.H0 > d.Hj ? d.H0 : d.Hj;
  const int S4 = round4(d.S), V4 = round4(d.V);
  size_t w = static_cast<size_t>(d.H0) * S4;
  const size_t cand[] = {static_cast<size_t>(d.S) * V4, static_cast<size_t>(Hm) * V4,
                         static_cast<size_t>(d.V) * round4(d.Hj),
                         static_cast<size_t>(d.S + d.Hj) * S4};
  for (size_t c : cand) w = c > w ? c : w;
  // activations, tile sums (kept a multiple of 4 floats), chunk rows,
  // compacted slots, destination starts + scan scratch, staged weights
  return static_cast<size_t>(d.S + Hm + d.V) * kLd + static_cast<size_t>(Hm + d.V) * kLd3 +
         round4(d.tile_n * (d.S + 3 * d.V)) + 3 * kRows + 3 * kThreads + kDests + 16 + w;
}

template <typename T>
int launch(const void* tab_s, const void* tab_v, const int* idx, const float* mask,
           const void* rterm, const void* dirterm, const void* wts, int B, const Dims& d,
           float* s_out, float* v_out, cudaStream_t stream) {
  // raise the kernel's shared-memory ceiling once (and again only for a
  // larger shape), so a launch inside a CUDA-graph capture makes no
  // attribute call
  static size_t configured = 0;
  const size_t smem = smem_floats(d) * sizeof(float);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(pp_message_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(d.tiles, B);
  pp_message_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(tab_s), static_cast<const T*>(tab_v), idx, mask,
      static_cast<const T*>(rterm), static_cast<const T*>(dirterm), static_cast<const T*>(wts), d,
      s_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int P, int copies, int Nd, int K, int S, int V, int H0, int Hj,
               int n_layers) {
  Dims d;
  d.P = P;
  d.copies = copies;
  d.Nd = Nd;
  d.K = K;
  d.S = S;
  d.V = V;
  d.H0 = H0;
  d.Hj = n_layers > 1 ? Hj : 0;
  d.n_layers = n_layers;
  d.tile_n = K > 0 ? (kThreads / K < kDests ? kThreads / K : kDests) : 0;
  d.tiles = d.tile_n > 0 ? (Nd + d.tile_n - 1) / d.tile_n : 0;
  return d;
}

}  // namespace

// Elements of the packed weight buffer (see ops/pp_message.py).
extern "C" int pp_message_weights_size(int S, int V, int H0, int Hj, int n_layers) {
  const Dims d = make_dims(1, 1, 1, 1, S, V, H0, Hj, n_layers);
  return layer0_size(d) + (n_layers - 1) * layerj_size(d);
}

// Dynamic shared memory of one block, in bytes.
extern "C" size_t pp_message_smem_bytes(int S, int V, int H0, int Hj, int n_layers) {
  return smem_floats(make_dims(1, 1, 1, 1, S, V, H0, Hj, n_layers)) * sizeof(float);
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
  const Dims d = make_dims(P, copies, Nd, K, S, V, H0, Hj, n_layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(tab_s, tab_v, idx, mask, rterm, dirterm, wts, B, d, s_out,
                                 v_out, st);
  return launch<float>(tab_s, tab_v, idx, mask, rterm, dirterm, wts, B, d, s_out, v_out, st);
}
