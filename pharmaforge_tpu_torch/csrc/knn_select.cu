// Per-step pf k-nearest-neighbor selection for the sampling chain (K1),
// with the pf/fp edge geometry as an optional epilogue of the same launch.
//
// Replaces the Pallas TPU kernel pharmaforge_tpu/ops/pallas/knn_select.py
// (`knn_select`, body `_kernel` / `_select_body`). For every (b, f) row:
// the masked fp32 squared distance from pharm centre f to every prot atom
// of batch row b, computed as (dx*dx + dy*dy) + dz*dz with one rounding
// per operation (invalid pairs hold 1e30), then K passes of (min, lowest
// index at the min, knock that slot out). A knocked-out slot never wins
// again: with K <= P some untaken slot always holds a value <= 1e30. So
// when fewer than K atoms are valid the extra passes walk the invalid
// slots in index order, exactly as lax.top_k does.
//
// Two entries share that selection:
// * knn_select_launch: idx [B,F,K] int32, dist [B,F,K] fp32 (a slot is
//   valid iff dist < 1e30) and the selected prot coordinates xg
//   [B,F,K,3] -- the JAX kernel's contract;
// * knn_pf_edges_launch: what the denoiser's pf and fp edges need, the
//   plain version's rounding points op for op (ops/knn_select.py::
//   knn_pf_edges_reference): idx [B,F,K] int64, mask [B,F,K] bool,
//   x_dir = (xg - x) / (sqrt(max(|xg - x|^2, 1e-8)) + 1e-8) [B,F,K,3],
//   x_dir_fp = -x_dir, and d_rbf [B,F,K,16] = exp(-(((d - mu) / sigma)^2))
//   with centres mu = 0, 1, ..., 15 and sigma = 15/16 (both exact).
//   The geometry is a template flag, so the selection-only entry pays
//   nothing for it.
//
// What bounds it. At the sampling shape (B=240, F=8, P=230, K=5) the fused
// entry reads ~0.74 MB and writes ~0.93 MB (about half a microsecond at
// 3.35 TB/s) and does ~B*F*P*(8+K) scalar operations: far below what one
// launch costs. What costs time is the dependent chain inside a row: the
// prot atoms' loads, then K passes that each need the previous pass's
// winner. The design keeps that chain short:
// 1. No shared memory and no block barrier. One warp per (b, f) row, four
//    rows a block; each lane issues the loads of all its NC candidates
//    (j = lane + 32 c) before the first use, straight into registers, and
//    keeps only their distances' bit patterns.
// 2. d2 >= +0, and so are 1e30 and +inf, so their fp32 bit patterns order
//    as uint32. A pass is two warp reductions (`redux.sync`): the min of
//    the lanes' local minima, then the lowest index among the lanes that
//    hold it. Only the winning lane knocks its slot out and rescans its NC
//    registers; the others keep their local minimum.
// 3. After the passes lane s holds the s-th neighbour. Lanes 0..K-1 read
//    its coordinates (just loaded, in L1), compute its geometry in
//    parallel and store coalesced; the K x 16 RBF values are spread over
//    all 32 lanes.
// NC is a template parameter: 8, 16 and 32 cover P <= 256, 512 and 1,024.
// Above that a variant keeps each warp's row of keys in shared memory
// (still 4 rows a block), the same passes reading it: P up to 14,528.
//
// On an H100 at the sampling shape the time is the longest row's chain:
// its loads (stride-3 4-byte loads, which keep the load/store unit busy)
// take the largest share, then the five passes (two dependent reductions
// and the winner's rescan each), then, fused, the geometry. Staging the
// pocket in shared memory, tree minima, a second minimum per lane, two
// rows a warp, 1, 2 or 8 rows a block, skipping masked rows and a ballot
// in place of the second reduction were each measured, in turns with this
// design on one card, and none was faster by more than a few percent
// (PERF.md).
//
// Graph-safe: no global counter; the shared-memory attribute of each
// variant is set once per device and size and cached. Built with
// --fmad=false and written with __f*_rn intrinsics so the distances are
// bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // a lane with no slot left offers it
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 4;                 // warps (rows) a block
constexpr int kMaxNC = 32;               // largest register variant
constexpr size_t kMaxSmem = 232448;      // shared memory a Hopper block may use
constexpr int kMaxDevices = 64;          // devices whose attribute is cached
constexpr int kRbfDim = 16;              // ops/geometry.py RBF_DIM
constexpr float kRbfSigma = 0.9375f;     // RBF_DMAX / RBF_DIM = 15 / 16

struct Args {
  const float* pharm_x;            // [rows, 3]
  const unsigned char* pharm_mask; // [rows]
  const float* prot_x;             // [B, P, 3]
  const unsigned char* prot_mask;  // [B, P]
  int rows, F, P, K;
  // selection only
  int* idx;
  float* dist;
  float* xg;
  // pf edges
  long long* idx64;
  unsigned char* mask;
  float* x_dir;
  float* x_dir_fp;
  float* d_rbf;
};

// the masked squared distance's bit pattern
__device__ __forceinline__ uint32_t dist_key(float ax, float ay, float az,
                                             float qx, float qy, float qz,
                                             bool valid) {
  const float dx = __fsub_rn(ax, qx);
  const float dy = __fsub_rn(ay, qy);
  const float dz = __fsub_rn(az, qz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return __float_as_uint(valid ? d2 : kBig);
}

// lane-local (min, lowest index at the min) over the lane's slots;
// (kNone, P) when it has none left. NC = 0: the keys are in shared memory.
template <int NC>
__device__ __forceinline__ void local_min(const uint32_t (&key)[NC > 0 ? NC : 1],
                                          const uint32_t* keys, int lane,
                                          int P, uint32_t& lv, int& lj) {
  lv = kNone;
  lj = P;
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (key[c] < lv) {
        lv = key[c];
        lj = lane + 32 * c;
      }
    }
  } else {
    for (int j = lane; j < P; j += 32) {
      const uint32_t v = keys[j];
      if (v < lv) {
        lv = v;
        lj = j;
      }
    }
  }
}

template <int NC, bool kEdges>
__global__ void __launch_bounds__(kRows * 32)
knn_select_kernel(const Args a) {
  extern __shared__ uint32_t smem_keys[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.rows) return;  // the whole warp
  const int P = a.P;
  const int b = row / a.F;
  const float* px = a.prot_x + static_cast<size_t>(b) * P * 3;
  const unsigned char* pm = a.prot_mask + static_cast<size_t>(b) * P;
  const float ax = __ldg(a.pharm_x + 3 * static_cast<size_t>(row));
  const float ay = __ldg(a.pharm_x + 3 * static_cast<size_t>(row) + 1);
  const float az = __ldg(a.pharm_x + 3 * static_cast<size_t>(row) + 2);
  const bool row_valid = a.pharm_mask[row] != 0;

  uint32_t key[NC > 0 ? NC : 1];
  uint32_t* keys = smem_keys + static_cast<size_t>(warp) * P;
  if constexpr (NC > 0) {
    // every load issued before the first use: a slot past P reads slot
    // P - 1 and is then given kNone
    float qx[NC], qy[NC], qz[NC];
    unsigned char qm[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = min(lane + 32 * c, P - 1);
      qx[c] = __ldg(px + 3 * j);
      qy[c] = __ldg(px + 3 * j + 1);
      qz[c] = __ldg(px + 3 * j + 2);
      qm[c] = __ldg(pm + j);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      key[c] = lane + 32 * c < P
                   ? dist_key(ax, ay, az, qx[c], qy[c], qz[c],
                              row_valid && qm[c] != 0)
                   : kNone;
  } else {
    // each lane reads and writes only its own slots j = lane (mod 32): no
    // barrier is needed
#pragma unroll 4
    for (int j = lane; j < P; j += 32)
      keys[j] = dist_key(ax, ay, az, __ldg(px + 3 * j), __ldg(px + 3 * j + 1),
                         __ldg(px + 3 * j + 2), row_valid && __ldg(pm + j) != 0);
  }
  uint32_t lv;
  int lj;
  local_min<NC>(key, keys, lane, P, lv, lj);

  for (int base = 0; base < a.K; base += 32) {
    const int kc = min(32, a.K - base);
    uint32_t my_v = kNone, my_i = 0;
    for (int s = 0; s < kc; ++s) {
      const uint32_t v = __reduce_min_sync(kFull, lv);
      const uint32_t i =
          __reduce_min_sync(kFull, lv == v ? static_cast<uint32_t>(lj) : kNone);
      if (lane == s) {
        my_v = v;
        my_i = i;
      }
      if (lane == static_cast<int>(i & 31)) {
        if constexpr (NC > 0) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c == static_cast<int>(i >> 5)) key[c] = kNone;
        } else {
          keys[i] = kNone;
        }
        local_min<NC>(key, keys, lane, P, lv, lj);
      }
    }

    // lane s < kc holds slot base + s of this row
    const size_t o = static_cast<size_t>(row) * a.K + base + lane;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (lane < kc) {
      gx = __ldg(px + 3 * my_i);
      gy = __ldg(px + 3 * my_i + 1);
      gz = __ldg(px + 3 * my_i + 2);
    }
    if constexpr (!kEdges) {
      if (lane < kc) {
        a.idx[o] = static_cast<int>(my_i);
        a.dist[o] = __uint_as_float(my_v);
        a.xg[3 * o] = gx;
        a.xg[3 * o + 1] = gy;
        a.xg[3 * o + 2] = gz;
      }
    } else {
      const float dx = __fsub_rn(gx, ax);
      const float dy = __fsub_rn(gy, ay);
      const float dz = __fsub_rn(gz, az);
      const float s2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float d = __fadd_rn(__fsqrt_rn(fmaxf(s2, 1e-8f)), 1e-8f);
      if (lane < kc) {
        a.idx64[o] = static_cast<long long>(my_i);
        a.mask[o] = __uint_as_float(my_v) < kBig;
        const float ux = __fdiv_rn(dx, d);
        const float uy = __fdiv_rn(dy, d);
        const float uz = __fdiv_rn(dz, d);
        a.x_dir[3 * o] = ux;
        a.x_dir[3 * o + 1] = uy;
        a.x_dir[3 * o + 2] = uz;
        a.x_dir_fp[3 * o] = -ux;
        a.x_dir_fp[3 * o + 1] = -uy;
        a.x_dir_fp[3 * o + 2] = -uz;
      }
      // the kc x 16 RBF values of these slots, contiguous, over all lanes
      float* rb = a.d_rbf + (static_cast<size_t>(row) * a.K + base) * kRbfDim;
      const int n = kc * kRbfDim;
#pragma unroll 4
      for (int e = lane; e < ((n + 31) & ~31); e += 32) {
        const float de = __shfl_sync(kFull, d, e / kRbfDim);
        if (e < n) {
          const float u = __fdiv_rn(
              __fsub_rn(de, static_cast<float>(e % kRbfDim)), kRbfSigma);
          rb[e] = expf(-__fmul_rn(u, u));
        }
      }
    }
  }
}

template <int NC, bool kEdges>
int launch_variant(const Args& a, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (NC == 0) {
    smem = static_cast<size_t>(kRows) * a.P * sizeof(uint32_t);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    // the attribute is per device: the largest size set on each, cached
    static size_t configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= kMaxDevices)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > 48 * 1024 && smem > configured[dev]) {
      e = cudaFuncSetAttribute(knn_select_kernel<NC, kEdges>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured[dev] = smem;
    }
  }
  const int blocks = (a.rows + kRows - 1) / kRows;
  knn_select_kernel<NC, kEdges><<<blocks, kRows * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kEdges>
int launch(const Args& a, void* stream) {
  if (a.rows <= 0) return 0;
  if (a.K < 1 || a.K > a.P) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.P <= 32 * 8) return launch_variant<8, kEdges>(a, st);
  if (a.P <= 32 * 16) return launch_variant<16, kEdges>(a, st);
  if (a.P <= 32 * kMaxNC) return launch_variant<kMaxNC, kEdges>(a, st);
  return launch_variant<0, kEdges>(a, st);
}

}  // namespace

// Shared memory a launch at P prot slots takes: 0 for the register
// variants (P <= 1,024), else the shared-memory variant's rows of keys.
// Above kMaxSmem the shape is not taken.
extern "C" size_t knn_select_smem_bytes(int P) {
  if (P <= 32 * kMaxNC) return 0;
  return static_cast<size_t>(kRows) * P * sizeof(uint32_t);
}

// RBF width of knn_pf_edges_launch's d_rbf
extern "C" int knn_select_rbf_dim() { return kRbfDim; }

// Launch on `stream`; return cudaGetLastError() (0 on success).
// Pointers: pharm_x [B,F,3] f32, pharm_mask [B,F] bool, prot_x [B,P,3]
// f32, prot_mask [B,P] bool, idx [B,F,K] i32, dist [B,F,K] f32,
// xg [B,F,K,3] f32, all contiguous on the current device. Requires
// 1 <= K <= P.
extern "C" int knn_select_launch(const float* pharm_x,
                                 const unsigned char* pharm_mask,
                                 const float* prot_x,
                                 const unsigned char* prot_mask,
                                 int B, int F, int P, int K,
                                 int* idx, float* dist, float* xg,
                                 void* stream) {
  Args a{pharm_x, pharm_mask, prot_x, prot_mask, B * F, F, P, K,
         idx, dist, xg, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<false>(a, stream);
}

// As knn_select_launch, with the pf edges as outputs: idx [B,F,K] i64,
// mask [B,F,K] bool, x_dir and x_dir_fp [B,F,K,3] f32, d_rbf
// [B,F,K,16] f32.
extern "C" int knn_pf_edges_launch(const float* pharm_x,
                                   const unsigned char* pharm_mask,
                                   const float* prot_x,
                                   const unsigned char* prot_mask,
                                   int B, int F, int P, int K,
                                   long long* idx, unsigned char* mask,
                                   float* x_dir, float* x_dir_fp, float* d_rbf,
                                   void* stream) {
  Args a{pharm_x, pharm_mask, prot_x, prot_mask, B * F, F, P, K,
         nullptr, nullptr, nullptr, idx, mask, x_dir, x_dir_fp, d_rbf};
  return launch<true>(a, stream);
}

