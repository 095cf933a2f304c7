// Per-step pf k-nearest-neighbor selection for the sampling chain.
//
// Replaces the Pallas TPU kernel pharmaforge_tpu/ops/pallas/knn_select.py
// (`knn_select`, body `_kernel` / `_select_body`). For every (b, f) row:
// the masked fp32 squared distance from pharm centre f to every prot atom
// of batch row b, computed as (dx*dx + dy*dy) + dz*dz with one rounding
// per operation (invalid pairs hold 1e30), then K passes of
// (min, lowest index at the min, knock that slot out with +inf). Knocked
// out slots (+inf) rank above the 1e30 sentinel, so when fewer than K
// atoms are valid the extra passes walk the invalid slots in index order,
// exactly as lax.top_k does. Outputs: idx [B,F,K] int32, dist [B,F,K]
// fp32 (a slot is valid iff dist < 1e30) and the selected prot
// coordinates xg [B,F,K,3], read directly (no one-hot sum).
//
// Bound: the kernel reads about B*P*13 + B*F*13 bytes and writes
// B*F*K*20 bytes -- about 1 MB at the sampling shape (B=240, F=8, P=230,
// K=5), a fraction of a microsecond of HBM time -- and does ~B*F*P*(8+K)
// scalar operations (the distance, then one compare per slot and pass). It is bound by launch latency, not by bytes or
// arithmetic. The design therefore spends one launch for the whole
// selection and gather: one block per batch row stages that row's P
// coordinates and mask in shared memory once for all its F pharm rows;
// one warp per pharm row keeps its P distances in shared memory and runs
// each pass as a warp (value, index) min-reduction with shuffles.
//
// Exactness: built with --fmad=false and written with __f*_rn intrinsics
// so the distances are bit-equal to the plain PyTorch version in
// pharmaforge_tpu_torch/ops/knn_select.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kMaxWarps = 8;

__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void knn_select_kernel(const float* __restrict__ pharm_x,
                                  const unsigned char* __restrict__ pharm_mask,
                                  const float* __restrict__ prot_x,
                                  const unsigned char* __restrict__ prot_mask,
                                  int F, int P, int K,
                                  int* __restrict__ idx_out,
                                  float* __restrict__ dist_out,
                                  float* __restrict__ xg_out) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  float* qx = smem;
  float* qy = qx + P;
  float* qz = qy + P;
  float* rows = qz + P;  // nwarps rows of P distances
  unsigned char* qm = reinterpret_cast<unsigned char*>(rows + nwarps * P);

  const int b = blockIdx.x;
  const float* px_b = prot_x + static_cast<size_t>(b) * P * 3;
  const unsigned char* pm_b = prot_mask + static_cast<size_t>(b) * P;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    qx[j] = px_b[3 * j];
    qy[j] = px_b[3 * j + 1];
    qz[j] = px_b[3 * j + 2];
    qm[j] = pm_b[j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + warp * P;
  for (int f = warp; f < F; f += nwarps) {
    const size_t bf = static_cast<size_t>(b) * F + f;
    const float ax = pharm_x[3 * bf];
    const float ay = pharm_x[3 * bf + 1];
    const float az = pharm_x[3 * bf + 2];
    const bool row_valid = pharm_mask[bf] != 0;
    for (int j = lane; j < P; j += 32) {
      const float dx = __fsub_rn(ax, qx[j]);
      const float dy = __fsub_rn(ay, qy[j]);
      const float dz = __fsub_rn(az, qz[j]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      row[j] = (row_valid && qm[j] != 0) ? d2 : kBig;
    }
    __syncwarp();
    for (int pass = 0; pass < K; ++pass) {
      // lane-local lexicographic min of (value, index); the first slot a
      // lane owns always seeds it, so the index is always in range
      float v = CUDART_INF_F;
      int i = P;
      for (int j = lane; j < P; j += 32) {
        const float r = row[j];
        if (r < v || i == P) {
          v = r;
          i = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        take_min(v, i, ov, oi);
      }
      if (lane == 0) {
        const size_t o = bf * K + pass;
        idx_out[o] = i;
        dist_out[o] = v;
        xg_out[3 * o] = qx[i];
        xg_out[3 * o + 1] = qy[i];
        xg_out[3 * o + 2] = qz[i];
        row[i] = CUDART_INF_F;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Shared memory one launch needs for P prot slots and F pharm rows.
extern "C" size_t knn_select_smem_bytes(int F, int P) {
  const int nwarps = F < kMaxWarps ? F : kMaxWarps;
  return sizeof(float) * static_cast<size_t>(P) * (3 + nwarps) + P;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
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
  if (B <= 0 || F <= 0) return 0;
  if (K < 1 || K > P) return static_cast<int>(cudaErrorInvalidValue);
  const int nwarps = F < kMaxWarps ? F : kMaxWarps;
  const size_t smem = knn_select_smem_bytes(F, P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  knn_select_kernel<<<B, nwarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      pharm_x, pharm_mask, prot_x, prot_mask, F, P, K, idx, dist, xg);
  return static_cast<int>(cudaGetLastError());
}
