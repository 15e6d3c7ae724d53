// Fused bundle-adjustment assembly and cost kernels for Hopper (sm_90a).
//
// Two kernels over the lane-major operands of solver/ba_core._kernel_inputs
// (every [rows, L] array is row-major, so thread l reads column l and a warp
// reads 32 consecutive floats of each row):
//
//   obs_t      [K*C*3, L]  (u, v, d) per keyframe, camera
//   repr_base  [K*C, L]    0/1 reprojection mask before the projection guard
//   depth_base [K*C, L]    0/1 depth mask before the cheirality guard
//   lm_t       [3, L]      landmark positions
//   wlm        [1, L]      landmark weights
//   pose_mats  [K, 12]     R_kf row-major + t_kf
//   cam_mats   [C, 15]     R_cv row-major + t_cv + (f, cx, cy)
//
// assemble_obs_kernel replaces limo_tpu/solver/pallas_assemble.py::_kernel
// (launched by assemble_obs_pallas). For every landmark x keyframe x camera
// it projects, forms the u/v/depth residuals with the |z| >= 0.01 and z > 0
// masks, the Cauchy IRLS weights times the landmark weight, the analytic
// pose (6) and landmark (3) Jacobians (solver/analytic.py), and accumulates
// the normal-equation blocks in registers. Outputs:
//   V_t   [9, L]            landmark Hessian blocks (full symmetric 3x3)
//   bl_t  [3, L]            landmark gradients
//   W_t   [K*18, L]         pose x landmark cross blocks, row k*18 + p*3 + a
//   up    [blocks, K, 42]   per-block partials: U (6x6 row-major, 36)
//                           then b_pose (6)
//   cost  [blocks]          per-block partial robust cost
//
// cost_obs_kernel replaces pallas_assemble.py::_cost_kernel (launched by
// cost_obs_pallas): the same residuals and masks, cost only.
//
// Bound on the H100: memory. At the bench width (K=20, C=1, L=1536) kernel 1
// reads 0.6 MB and writes 2.3 MB (W dominates), under a microsecond at
// 3.35 TB/s, and does about 14 MFLOP of f32 (0.2 us at 67 TFLOP/s). Both
// kernels are far below either bound: with one thread per landmark the
// launch holds L/128 blocks (12 at the bench width), so the time is the
// serial latency of one thread's K*C loop plus the launch.
//
// Design: one thread per landmark, looping over K and C as the TPU kernel's
// unrolled loops did; V/b_l/W/U/b_pose stay in registers (about 55
// accumulators). U/b_pose/cost are reduced across the block with warp
// shuffles and shared memory into per-block partials that the wrapper sums
// in a fixed order: no atomics, so repeated solves are bit-identical. The
// ragged last block is masked here, so L needs no alignment. The residual
// and cost arithmetic is shared by both kernels (observe / cost_term /
// block_cost) and the file is compiled with -fmad=false, so on the same
// inputs the two kernels give bit-identical costs and LM accept/reject
// compares like with like.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kUB = 27;  // per keyframe: 21 U upper-triangle entries + 6 b_pose
constexpr int kUP = 42;  // per keyframe in the output: U as 6x6 + 6 b_pose

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the warp's sum
}

// Keyframe transform of the landmark: y = R x, pv = y + t.
__device__ __forceinline__ void to_keyframe(const float* P, float x0, float x1, float x2,
                                            float y[3], float pv[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = P[3 * i] * x0 + P[3 * i + 1] * x1 + P[3 * i + 2] * x2;
    pv[i] = y[i] + P[9 + i];
  }
}

struct Obs {
  float p0, p1, z;   // camera-frame point
  float xz, yz, fz;  // x/z, y/z, f/z
  float r_u, r_v, r_d;
  float m_repr, m_depth;
  float s_repr, s_dep;
};

// Residuals and masks of one observation (camera A = cam_mats row).
__device__ __forceinline__ Obs observe(const float* A, const float pv[3], float ou, float ov,
                                       float od, float rb, float db) {
  Obs o;
  o.p0 = A[0] * pv[0] + A[1] * pv[1] + A[2] * pv[2] + A[9];
  o.p1 = A[3] * pv[0] + A[4] * pv[1] + A[5] * pv[2] + A[10];
  o.z = A[6] * pv[0] + A[7] * pv[1] + A[8] * pv[2] + A[11];
  const bool proj_ok = fabsf(o.z) >= 0.01f;
  const float inv_z = 1.0f / (proj_ok ? o.z : 1.0f);
  o.xz = o.p0 * inv_z;
  o.yz = o.p1 * inv_z;
  o.fz = A[12] * inv_z;
  o.r_u = A[12] * o.xz + A[13] - ou;
  o.r_v = A[12] * o.yz + A[14] - ov;
  o.r_d = o.z - od;
  o.m_repr = proj_ok ? rb : 0.0f;
  o.m_depth = o.z > 0.0f ? db : 0.0f;
  o.s_repr = o.r_u * o.r_u + o.r_v * o.r_v;
  o.s_dep = o.r_d * o.r_d;
  return o;
}

// Robust (Cauchy) cost of one observation, 0.5 * w * rho(s) per family.
__device__ __forceinline__ float cost_term(const Obs& o, float w_lm, float a2r, float a2d) {
  return 0.5f * w_lm * (o.m_repr * a2r * log1pf(o.s_repr / a2r) +
                        o.m_depth * a2d * log1pf(o.s_dep / a2d));
}

// Block sum of the per-thread cost in a fixed order; thread 0 writes it.
__device__ __forceinline__ void block_cost(float cost, float* s_cost, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float v = warp_sum(cost);
  if (lane == 0) s_cost[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_cost[w];
    *out = s;
  }
}

// Copies the per-keyframe and per-camera constants into shared memory.
__device__ __forceinline__ void load_constants(const float* pose_mats, const float* cam_mats,
                                               int K, int C, float* s_pose, float* s_cam) {
  for (int i = threadIdx.x; i < K * 12; i += blockDim.x) s_pose[i] = pose_mats[i];
  for (int i = threadIdx.x; i < C * 15; i += blockDim.x) s_cam[i] = cam_mats[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
assemble_obs_kernel(const float* __restrict__ obs_t, const float* __restrict__ repr_base,
                    const float* __restrict__ depth_base, const float* __restrict__ lm_t,
                    const float* __restrict__ wlm, const float* __restrict__ pose_mats,
                    const float* __restrict__ cam_mats, int K, int C, int L, float a2r,
                    float a2d, float* __restrict__ V_t, float* __restrict__ bl_t,
                    float* __restrict__ W_t, float* __restrict__ up,
                    float* __restrict__ cost_out) {
  extern __shared__ float smem[];
  float* s_pose = smem;                 // [K*12]
  float* s_cam = s_pose + K * 12;       // [C*15]
  float* s_red = s_cam + C * 15;        // [kWarps][K][27]
  float* s_cost = s_red + kWarps * K * kUB;  // [kWarps]
  load_constants(pose_mats, cam_mats, K, C, s_pose, s_cam);

  const int l = blockIdx.x * kBlock + threadIdx.x;
  const bool active = l < L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float x0 = active ? lm_t[l] : 0.0f;
  const float x1 = active ? lm_t[L + l] : 0.0f;
  const float x2 = active ? lm_t[2 * L + l] : 0.0f;
  const float w_lm = active ? wlm[l] : 0.0f;

  float V[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // upper triangle, row-major
  float bl[3] = {0.f, 0.f, 0.f};
  float cost = 0.0f;

  for (int k = 0; k < K; ++k) {
    const float* P = s_pose + 12 * k;
    float y[3], pv[3];
    to_keyframe(P, x0, x1, x2, y, pv);
    float U[21], bp[6], W[18];
#pragma unroll
    for (int i = 0; i < 21; ++i) U[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) bp[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 18; ++i) W[i] = 0.0f;

    for (int c = 0; c < C; ++c) {
      const float* A = s_cam + 15 * c;
      const int row = k * C + c;
      float ou = 0.f, ov = 0.f, od = 0.f, rb = 0.f, db = 0.f;
      if (active) {
        ou = obs_t[(3 * row) * L + l];
        ov = obs_t[(3 * row + 1) * L + l];
        od = obs_t[(3 * row + 2) * L + l];
        rb = repr_base[row * L + l];
        db = depth_base[row * L + l];
      }
      const Obs o = observe(A, pv, ou, ov, od, rb, db);
      cost += cost_term(o, w_lm, a2r, a2d);
      const float w_r = o.m_repr * w_lm / (1.0f + o.s_repr / a2r);
      const float w_d = o.m_depth * w_lm / (1.0f + o.s_dep / a2d);

      // Jacobian rows: pose columns (w then dt), landmark columns.
      float Ju[6], Jv[6], Jd[6], Lu[3], Lv[3], Ld[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // column j of A @ skew(y), times -2
        const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
        const float d0 = -2.0f * (A[j1] * y[j2] - A[j2] * y[j1]);
        const float d1 = -2.0f * (A[3 + j1] * y[j2] - A[3 + j2] * y[j1]);
        const float d2 = -2.0f * (A[6 + j1] * y[j2] - A[6 + j2] * y[j1]);
        Ju[j] = o.fz * (d0 - o.xz * d2);
        Jv[j] = o.fz * (d1 - o.yz * d2);
        Jd[j] = d2;
        Ju[3 + j] = o.fz * (A[j] - o.xz * A[6 + j]);
        Jv[3 + j] = o.fz * (A[3 + j] - o.yz * A[6 + j]);
        Jd[3 + j] = A[6 + j];
        // column j of A @ R
        const float ar0 = A[0] * P[j] + A[1] * P[3 + j] + A[2] * P[6 + j];
        const float ar1 = A[3] * P[j] + A[4] * P[3 + j] + A[5] * P[6 + j];
        const float ar2 = A[6] * P[j] + A[7] * P[3 + j] + A[8] * P[6 + j];
        Lu[j] = o.fz * (ar0 - o.xz * ar2);
        Lv[j] = o.fz * (ar1 - o.yz * ar2);
        Ld[j] = ar2;
      }

      int t = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = a; b < 3; ++b, ++t)
          V[t] += w_r * (Lu[a] * Lu[b] + Lv[a] * Lv[b]) + w_d * Ld[a] * Ld[b];
        bl[a] -= w_r * (Lu[a] * o.r_u + Lv[a] * o.r_v) + w_d * Ld[a] * o.r_d;
      }
      t = 0;
#pragma unroll
      for (int p = 0; p < 6; ++p) {
#pragma unroll
        for (int q = p; q < 6; ++q, ++t)
          U[t] += w_r * (Ju[p] * Ju[q] + Jv[p] * Jv[q]) + w_d * Jd[p] * Jd[q];
        bp[p] -= w_r * (Ju[p] * o.r_u + Jv[p] * o.r_v) + w_d * Jd[p] * o.r_d;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          W[p * 3 + a] += w_r * (Ju[p] * Lu[a] + Jv[p] * Lv[a]) + w_d * Jd[p] * Ld[a];
      }
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < 18; ++i) W_t[(k * 18 + i) * L + l] = W[i];
    }
    // per-warp sums of this keyframe's U / b_pose into shared memory
    float* red = s_red + (warp * K + k) * kUB;
#pragma unroll
    for (int i = 0; i < 21; ++i) {
      const float v = warp_sum(U[i]);
      if (lane == 0) red[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float v = warp_sum(bp[i]);
      if (lane == 0) red[21 + i] = v;
    }
  }

  if (active) {
    const int sym[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
#pragma unroll
    for (int i = 0; i < 9; ++i) V_t[i * L + l] = V[sym[i]];
#pragma unroll
    for (int i = 0; i < 3; ++i) bl_t[i * L + l] = bl[i];
  }

  block_cost(cost, s_cost, cost_out + blockIdx.x);  // ends with a barrier
  // s_red is complete: every warp wrote before the barrier in block_cost.
  // Sum the warps in a fixed order; write U as a full symmetric 6x6.
  float* out = up + (size_t)blockIdx.x * K * kUP;
  for (int i = threadIdx.x; i < K * kUP; i += kBlock) {
    const int k = i / kUP, j = i % kUP;
    int src = 21 + (j - 36);  // b_pose
    if (j < 36) {
      const int p = min(j / 6, j % 6), q = max(j / 6, j % 6);
      src = 6 * p - p * (p - 1) / 2 + (q - p);  // upper-triangle slot
    }
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_red[(w * K + k) * kUB + src];
    out[i] = s;
  }
}

__global__ void __launch_bounds__(kBlock)
cost_obs_kernel(const float* __restrict__ obs_t, const float* __restrict__ repr_base,
                const float* __restrict__ depth_base, const float* __restrict__ lm_t,
                const float* __restrict__ wlm, const float* __restrict__ pose_mats,
                const float* __restrict__ cam_mats, int K, int C, int L, float a2r, float a2d,
                float* __restrict__ cost_out) {
  extern __shared__ float smem[];
  float* s_pose = smem;
  float* s_cam = s_pose + K * 12;
  float* s_cost = s_cam + C * 15;
  load_constants(pose_mats, cam_mats, K, C, s_pose, s_cam);

  const int l = blockIdx.x * kBlock + threadIdx.x;
  const bool active = l < L;
  const float x0 = active ? lm_t[l] : 0.0f;
  const float x1 = active ? lm_t[L + l] : 0.0f;
  const float x2 = active ? lm_t[2 * L + l] : 0.0f;
  const float w_lm = active ? wlm[l] : 0.0f;
  float cost = 0.0f;
  for (int k = 0; k < K; ++k) {
    float y[3], pv[3];
    to_keyframe(s_pose + 12 * k, x0, x1, x2, y, pv);
    for (int c = 0; c < C; ++c) {
      const int row = k * C + c;
      float ou = 0.f, ov = 0.f, od = 0.f, rb = 0.f, db = 0.f;
      if (active) {
        ou = obs_t[(3 * row) * L + l];
        ov = obs_t[(3 * row + 1) * L + l];
        od = obs_t[(3 * row + 2) * L + l];
        rb = repr_base[row * L + l];
        db = depth_base[row * L + l];
      }
      cost += cost_term(observe(s_cam + 15 * c, pv, ou, ov, od, rb, db), w_lm, a2r, a2d);
    }
  }
  block_cost(cost, s_cost, cost_out + blockIdx.x);
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

int limo_block_size() { return kBlock; }

int limo_assemble_obs(const float* obs_t, const float* repr_base, const float* depth_base,
                      const float* lm_t, const float* wlm, const float* pose_mats,
                      const float* cam_mats, int K, int C, int L, float a2r, float a2d,
                      float* V_t, float* bl_t, float* W_t, float* up, float* cost,
                      void* stream) {
  const int blocks = (L + kBlock - 1) / kBlock;
  const size_t smem = sizeof(float) * (K * 12 + C * 15 + kWarps * K * kUB + kWarps);
  int err = set_smem((const void*)assemble_obs_kernel, smem);
  if (err) return err;
  assemble_obs_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
      obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats, K, C, L, a2r, a2d, V_t,
      bl_t, W_t, up, cost);
  return (int)cudaGetLastError();
}

int limo_cost_obs(const float* obs_t, const float* repr_base, const float* depth_base,
                  const float* lm_t, const float* wlm, const float* pose_mats,
                  const float* cam_mats, int K, int C, int L, float a2r, float a2d,
                  float* cost, void* stream) {
  const int blocks = (L + kBlock - 1) / kBlock;
  const size_t smem = sizeof(float) * (K * 12 + C * 15 + kWarps);
  int err = set_smem((const void*)cost_obs_kernel, smem);
  if (err) return err;
  cost_obs_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
      obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats, K, C, L, a2r, a2d, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
