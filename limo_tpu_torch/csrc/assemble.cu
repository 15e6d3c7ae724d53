// Fused bundle-adjustment assembly and cost kernels for Hopper (sm_90a).
//
// Inputs, the lane-major operands of solver/ba_core._kernel_inputs (every
// [rows, L] array is row-major, so the lanes of a tile read consecutive
// floats of a row):
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
// masks, the Cauchy IRLS weights times the landmark weight and the analytic
// pose (6) and landmark (3) Jacobians (solver/analytic.py), and sums the
// normal-equation blocks. It writes the public layouts of ObsBlocks:
//   V [L,3,3]  b_l [L,3]  W [L,K,6,3]  U [K,6,6] (full symmetric)
//   b_pose [K,6]  cost []
// cost_obs_kernel replaces pallas_assemble.py::_cost_kernel (launched by
// cost_obs_pallas): the same residuals and masks, cost only.
//
// Bound on the H100: bytes. At the bench width (K=20, C=1, L=1536) kernel 1
// reads 0.6 MB and writes 2.3 MB (W dominates), under a microsecond at
// 3.35 TB/s; its ~19 MFLOP of f32 take 0.3 us at 67 TFLOP/s. Neither bound
// is near: at this width the time is the latency of one thread's chain of
// dependent f32 operations, of the loads of the last block's cross-block
// sum, and of the launch itself (an empty kernel on the same grid: ~0.8 us).
//
// Mapping: one thread per (landmark, keyframe) pair. A block holds a tile of
// 16 landmarks and 16 warps; each warp holds two keyframes, one per
// half-warp (lane li + 16 * sub holds landmark li of keyframe slot
// 2 * warp + sub), so a round covers 32 keyframes, and each thread loops over
// the C cameras. At the bench width that is 96 blocks of 512 threads and one
// round: one keyframe per thread. K > 32 takes more rounds; the block size is
// fixed, so the registers do not depend on K. A half-warp's loads stay
// coalesced: lane li reads column l0 + li of its keyframe's rows.
// The choice (measured on the H100, PERF.md section 6): of 32 x 8, 32 x 16,
// 16 x 8, 16 x 12 and 16 x 16 landmarks x warps, 16 x 16 was the fastest; it
// fills 96 SMs instead of 48 and needs one round at K <= 32. ptxas caps it at
// 128 registers (512 threads), with 36 bytes of spills; 16 x 12 (168
// registers, no spills) was ~0.5 us slower.
//
// Reductions, all in a fixed order and without floating-point atomics, so
// repeated solves are bit-identical:
//   U[k], b_pose[k]  each thread writes its keyframe's 27 values to its
//                    warp's rows in shared memory; lane r of the warp then
//                    sums row r over the tile's lanes in lane order and writes
//                    it to the block's partial row [block][k*27 + r] (one
//                    lane per row in place of 27 five-step shuffle sums).
//   V[l], b_l[l]     each thread sums its keyframes in registers; the block
//                    sums its keyframe slots in slot order through shared
//                    memory.
//   cost             per thread, per warp, per block (warp order), then over
//                    the blocks (warp 0 of the last block: lane j sums blocks
//                    j, j + 32, ..., then the lanes): block_cost / grid_cost,
//                    shared by both kernels.
//   across blocks    "last block done": each block writes its partials,
//                    fences, and takes a ticket with one integer atomicAdd;
//                    the last block sums every partial row (float4 columns,
//                    a fixed number of block segments per column, segments in
//                    order), writes U (both triangles), b_pose and the cost,
//                    and resets the counter to 0 for the next launch. The
//                    wrapper keeps one counter per device and stream, so
//                    the launches that share it run one after another.
// W is staged in shared memory one round (32 keyframes) at a time: a
// landmark's keyframes of a round are contiguous floats of W, so the block
// stores them coalesced, and the stage (37 KB) does not grow with K.
//
// Both kernels call the same device functions for the residuals and the cost
// (observe, cost_term, block_cost, grid_cost) with the same mapping, and the
// file is compiled with -fmad=false, so on the same inputs the two kernels'
// costs are bit-identical and LM accept/reject compares like with like.
//
// What Hopper offers that these kernels do not use, and why: no tensor
// cores (wgmma has no full-f32 mode, and the normal equations stay full f32:
// a reduced-precision Schur step cost the reference package 6.8 m of ATE
// against 0.32 m, and the port pins TF32 off); no TMA (a block reads about
// 7 KB of operands); no clusters yet, though a cluster could pre-sum its
// blocks' partial rows through distributed shared memory and shorten the
// last block's sum, a third of the kernel's time (PERF.md). What applies:
// filling SMs, coalesced loads and stores, shared-memory staging.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                // landmarks per block: a half-warp of one keyframe
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;    // threads per block
constexpr int kSub = 32 / kTile;         // keyframes a warp holds at once
constexpr int kRound = kWarps * kSub;    // keyframes per round of the block
constexpr int kUB = 27;  // partial per keyframe: 21 U upper-triangle entries + 6 b_pose
constexpr int kW = 18;   // W block of one (landmark, keyframe): 6x3
constexpr int kStage = kRound * kW + 1;  // floats per landmark in the W stage (+1: no bank conflicts)
constexpr int kRed = kSub * kUB * (kTile + 1);  // floats per warp for its U / b_pose rows
constexpr int kDevices = 64;             // devices whose shared-memory cap is recorded

int grid_blocks(int L) { return (L + kTile - 1) / kTile; }

// Index of (a, b) in the row-major upper triangle of a symmetric n x n block.
__device__ __forceinline__ int tri(int n, int a, int b) {
  const int p = min(a, b), q = max(a, b);
  return n * p - p * (p - 1) / 2 + (q - p);
}

// Every lane gets the same sum (each butterfly step adds a pair both ways).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Keyframe k's pose row; the lanes of a tile row read the same address.
__device__ __forceinline__ void load_pose(const float* pose_mats, int k, float P[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = __ldg(pose_mats + 12 * k + i);
}

struct Meas {
  float u, v, d, rb, db;  // measurement and the two base masks
};

// The measurement of landmark l in row (keyframe, camera); zeros where the
// slot does not exist (landmark past L, keyframe past K).
__device__ __forceinline__ Meas load_meas(const float* obs_t, const float* repr_base,
                                          const float* depth_base, int row, int l, int L,
                                          bool active) {
  Meas m = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    m.u = obs_t[(size_t)(3 * row) * L + l];
    m.v = obs_t[(size_t)(3 * row + 1) * L + l];
    m.d = obs_t[(size_t)(3 * row + 2) * L + l];
    m.rb = repr_base[(size_t)row * L + l];
    m.db = depth_base[(size_t)row * L + l];
  }
  return m;
}

struct Obs {
  float p0, p1, z;   // camera-frame point
  float xz, yz, fz;  // x/z, y/z, f/z
  float r_u, r_v, r_d;
  float m_repr, m_depth;
  float s_repr, s_dep;
};

// Residuals and masks of one observation (camera A = cam_mats row).
__device__ __forceinline__ Obs observe(const float* A, const float pv[3], const Meas& m) {
  Obs o;
  o.p0 = A[0] * pv[0] + A[1] * pv[1] + A[2] * pv[2] + A[9];
  o.p1 = A[3] * pv[0] + A[4] * pv[1] + A[5] * pv[2] + A[10];
  o.z = A[6] * pv[0] + A[7] * pv[1] + A[8] * pv[2] + A[11];
  const bool proj_ok = fabsf(o.z) >= 0.01f;
  const float inv_z = 1.0f / (proj_ok ? o.z : 1.0f);
  o.xz = o.p0 * inv_z;
  o.yz = o.p1 * inv_z;
  o.fz = A[12] * inv_z;
  o.r_u = A[12] * o.xz + A[13] - m.u;
  o.r_v = A[12] * o.yz + A[14] - m.v;
  o.r_d = o.z - m.d;
  o.m_repr = proj_ok ? m.rb : 0.0f;
  o.m_depth = o.z > 0.0f ? m.db : 0.0f;
  o.s_repr = o.r_u * o.r_u + o.r_v * o.r_v;
  o.s_dep = o.r_d * o.r_d;
  return o;
}

// Robust (Cauchy) cost of one observation, 0.5 * w * rho(s) per family.
__device__ __forceinline__ float cost_term(const Obs& o, float w_lm, float a2r, float a2d) {
  return 0.5f * w_lm * (o.m_repr * a2r * log1pf(o.s_repr / a2r) +
                        o.m_depth * a2d * log1pf(o.s_dep / a2d));
}

// Block sum of the per-thread cost (warps in order) into part[blockIdx.x].
// Ends with a barrier before thread 0's store.
__device__ __forceinline__ void block_cost(float cost, float* s_cost, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float v = warp_sum(cost);
  if (lane == 0) s_cost[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_cost[w];
    part[blockIdx.x] = s;
  }
}

// Called by every thread once the block's partials are written. Returns true
// in the block that arrives last, which may then read every block's partials.
__device__ __forceinline__ bool arrive_last(unsigned* counter) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

// In the last block, warp 0: the blocks' cost partials summed in a fixed
// order (lane j sums blocks j, j + 32, ...; then the lanes by butterfly).
__device__ __forceinline__ void grid_cost(const float* part, float* out) {
  if (threadIdx.x >= 32) return;
  float s = 0.0f;
#pragma unroll 4
  for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) s += __ldcg(part + b);
  s = warp_sum(s);
  if (threadIdx.x == 0) *out = s;
}

// Floats of one block's U / b_pose partial row: K * 27, padded to whole
// float4s (the wrapper allocates the partials with the same rule).
__device__ __forceinline__ int ub_row(int K) { return (K * kUB + 3) / 4 * 4; }

// Writes the sum v of the U / b_pose partial rows (keyframe v / 27, entry
// v % 27: U's upper triangle, then b_pose) to its place in U (both ways) or
// b_pose; v past the last keyframe is padding.
__device__ __forceinline__ void put_ub(int v, float sum, int K, float* U_out, float* bp_out) {
  const int k = v / kUB, e = v - k * kUB;
  if (k >= K) return;
  if (e >= 21) {
    bp_out[k * 6 + (e - 21)] = sum;
    return;
  }
  int p = 0, q = e;  // upper-triangle entry e -> (p, q)
  while (q >= 6 - p) q -= 6 - p, ++p;
  q += p;
  U_out[k * 36 + p * 6 + q] = sum;
  U_out[k * 36 + q * 6 + p] = sum;
}

// In the last block, after its reads: ready the counter for the next launch.
__device__ __forceinline__ void release(unsigned* counter) {
  if (threadIdx.x == 0) *counter = 0u;
}

__device__ __forceinline__ void load_cams(const float* cam_mats, int C, float* s_cam) {
  for (int i = threadIdx.x; i < C * 15; i += blockDim.x) s_cam[i] = cam_mats[i];
  __syncthreads();
}

// One landmark's observations in keyframe k over the C cameras: adds its
// V / b_l / cost terms to V, bl, cost and sets this keyframe's U, bp, W.
__device__ __forceinline__ void assemble_keyframe(
    const float* obs_t, const float* repr_base, const float* depth_base,
    const float* pose_mats, const float* s_cam, int k, int C, int l, int L, bool active,
    float x0, float x1, float x2, float w_lm, float a2r, float a2d, float V[6], float bl[3],
    float& cost, float U[21], float bp[6], float W[18]) {
  float P[12], y[3], pv[3];
  load_pose(pose_mats, k, P);
  to_keyframe(P, x0, x1, x2, y, pv);
#pragma unroll
  for (int i = 0; i < 21; ++i) U[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) bp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 18; ++i) W[i] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const float* A = s_cam + 15 * c;
    const Obs o = observe(A, pv, load_meas(obs_t, repr_base, depth_base, k * C + c, l, L,
                                           active));
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
}

// This thread's place in the block: landmark li of the tile, keyframe slot
// `slot` of each round (lanes li + kTile * sub of warp w hold slot w*kSub+sub).
struct Place {
  int li, slot;
};

__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x & 31;
  return {lane % kTile, (int)(threadIdx.x >> 5) * kSub + lane / kTile};
}

__global__ void __launch_bounds__(kThreads)
assemble_obs_kernel(const float* __restrict__ obs_t, const float* __restrict__ repr_base,
                    const float* __restrict__ depth_base, const float* __restrict__ lm_t,
                    const float* __restrict__ wlm, const float* __restrict__ pose_mats,
                    const float* __restrict__ cam_mats, int K, int C, int L, float a2r,
                    float a2d, float* __restrict__ V_out, float* __restrict__ bl_out,
                    float* __restrict__ W_out, float* __restrict__ U_out,
                    float* __restrict__ bp_out, float* __restrict__ cost_out,
                    float* __restrict__ part_ub, float* __restrict__ part_cost,
                    unsigned* __restrict__ counter) {
  extern __shared__ float smem[];
  // [kTile][kStage]: the W stage, then the V / b_l sums, then the last
  // block's float4 sums (first, so 16-byte aligned)
  float* s_stage = smem;
  float* s_red = s_stage + kTile * kStage;  // [kWarps][kRed]: U / b_pose rows
  float* s_cost = s_red + kWarps * kRed;    // [kWarps]
  float* s_cam = s_cost + kWarps;           // [C*15]
  load_cams(cam_mats, C, s_cam);

  const Place me = place();
  const int warp_slot = (int)(threadIdx.x >> 5) * kSub;  // the warp's first slot
  const int l0 = blockIdx.x * kTile, l = l0 + me.li;
  const int n_l = min(kTile, L - l0);  // landmarks of this block (ragged last block)
  const int n_pad = ub_row(K);
  const bool active = l < L;
  const float x0 = active ? lm_t[l] : 0.0f;
  const float x1 = active ? lm_t[L + l] : 0.0f;
  const float x2 = active ? lm_t[2 * L + l] : 0.0f;
  const float w_lm = active ? wlm[l] : 0.0f;

  float V[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // upper triangle, row-major
  float bl[3] = {0.f, 0.f, 0.f};
  float cost = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kRound) {  // rounds; the same for every warp
    if (k0 + warp_slot < K) {  // the warp holds a keyframe (the branch is warp-uniform)
      // A half-warp whose keyframe is past K computes on zeros: its
      // contributions are 0.
      const int k = k0 + me.slot;
      const bool kf_ok = k < K;
      float U[21], bp[6], W[18];
      assemble_keyframe(obs_t, repr_base, depth_base, pose_mats, s_cam, min(k, K - 1), C, l,
                        L, active && kf_ok, x0, x1, x2, w_lm, a2r, a2d, V, bl, cost, U, bp,
                        W);
      // this keyframe's U / b_pose summed over the tile row in lane order,
      // through the warp's rows of shared memory: lane s sums row s
      float* red = s_red + (threadIdx.x >> 5) * kRed;  // [kSub*27][kTile+1]
      float* mine = red + (me.slot - warp_slot) * kUB * (kTile + 1) + me.li;
#pragma unroll
      for (int i = 0; i < 21; ++i) mine[i * (kTile + 1)] = U[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) mine[(21 + i) * (kTile + 1)] = bp[i];
      __syncwarp();
      for (int r = threadIdx.x & 31; r < kSub * kUB; r += 32) {
        const int kr = k0 + warp_slot + r / kUB;  // the row's keyframe
        const float* row = red + r * (kTile + 1);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kTile; ++j) sum += row[j];
        if (kr < K) part_ub[(size_t)blockIdx.x * n_pad + kr * kUB + r % kUB] = sum;
      }
      float* st = s_stage + me.li * kStage + me.slot * kW;
#pragma unroll
      for (int i = 0; i < kW; ++i) st[i] = W[i];
    }
    __syncthreads();
    // landmark l0 + j's keyframes k0 .. k0 + n_k - 1 are seg contiguous floats of W
    const int seg = min(kRound, K - k0) * kW;
    int j = threadIdx.x / seg, off = threadIdx.x - j * seg;
    for (; j < n_l; off += kThreads) {
      while (off >= seg) off -= seg, ++j;  // (j, off) of entry j * seg + off
      if (j < n_l) W_out[((size_t)(l0 + j) * K + k0) * kW + off] = s_stage[j * kStage + off];
    }
    __syncthreads();
  }

  // V / b_l: the block's slots summed in slot order (the stage is free now)
  float* s_vb = s_stage;  // [kRound][kTile][9]: V upper triangle (6), b_l (3)
  float* vb = s_vb + (me.slot * kTile + me.li) * 9;
#pragma unroll
  for (int i = 0; i < 6; ++i) vb[i] = V[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) vb[6 + i] = bl[i];
  block_cost(cost, s_cost, part_cost);  // its barrier completes s_vb
  for (int t = threadIdx.x; t < n_l * 12; t += kThreads) {
    const bool is_v = t < n_l * 9;  // V entries first, then b_l
    const int j = is_v ? t / 9 : (t - n_l * 9) / 3;
    const int e = is_v ? t - 9 * j : t - n_l * 9 - 3 * j;
    const int src = is_v ? tri(3, e / 3, e % 3) : 6 + e;
    float s = 0.0f;
    for (int r = 0; r < kRound; ++r) s += s_vb[(r * kTile + j) * 9 + src];
    if (is_v)
      V_out[(size_t)l0 * 9 + t] = s;
    else
      bl_out[(size_t)l0 * 3 + (t - n_l * 9)] = s;
  }

  const bool last = arrive_last(counter);
  if (!last) return;
  grid_cost(part_cost, cost_out);
  // U and b_pose: the blocks' partial rows summed in a fixed order, a float4
  // column at a time: n_seg threads per column each sum every n_seg-th
  // block, then one thread sums the segments in order
  const int n_col = n_pad / 4, n_seg = max(1, min(kThreads / n_col, 8));
  const int width = kThreads / n_seg;  // columns per pass
  const int c = threadIdx.x % width, seg = threadIdx.x / width;
  float4* s_acc = reinterpret_cast<float4*>(s_stage);  // [n_seg][width]
  for (int c0 = 0; c0 < n_col; c0 += width) {
    if (seg < n_seg && c0 + c < n_col) {
      float4 a = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int b = seg; b < (int)gridDim.x; b += n_seg) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(part_ub + (size_t)b * n_pad) +
                                c0 + c);
        a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      }
      s_acc[seg * width + c] = a;
    }
    __syncthreads();
    if (threadIdx.x < width && c0 + threadIdx.x < n_col) {
      float4 a = s_acc[threadIdx.x];
      for (int g = 1; g < n_seg; ++g) {
        const float4 x = s_acc[g * width + threadIdx.x];
        a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      }
      const int v = 4 * (c0 + threadIdx.x);
      put_ub(v, a.x, K, U_out, bp_out);
      put_ub(v + 1, a.y, K, U_out, bp_out);
      put_ub(v + 2, a.z, K, U_out, bp_out);
      put_ub(v + 3, a.w, K, U_out, bp_out);
    }
    __syncthreads();
  }
  release(counter);
}

__global__ void __launch_bounds__(kThreads)
cost_obs_kernel(const float* __restrict__ obs_t, const float* __restrict__ repr_base,
                const float* __restrict__ depth_base, const float* __restrict__ lm_t,
                const float* __restrict__ wlm, const float* __restrict__ pose_mats,
                const float* __restrict__ cam_mats, int K, int C, int L, float a2r, float a2d,
                float* __restrict__ cost_out, float* __restrict__ part_cost,
                unsigned* __restrict__ counter) {
  extern __shared__ float smem[];
  float* s_cam = smem;              // [C*15]
  float* s_cost = s_cam + C * 15;   // [kWarps]
  load_cams(cam_mats, C, s_cam);

  const Place me = place();
  const int l = blockIdx.x * kTile + me.li;
  const bool active = l < L;
  const float x0 = active ? lm_t[l] : 0.0f;
  const float x1 = active ? lm_t[L + l] : 0.0f;
  const float x2 = active ? lm_t[2 * L + l] : 0.0f;
  const float w_lm = active ? wlm[l] : 0.0f;
  float cost = 0.0f;
  // this thread's keyframes in the order of assemble_obs_kernel's rounds
  // (there a half-warp past K adds zeros, which leave the sum as it is)
  for (int k = me.slot; k < K; k += kRound) {
    float P[12], y[3], pv[3];
    load_pose(pose_mats, k, P);
    to_keyframe(P, x0, x1, x2, y, pv);
    for (int c = 0; c < C; ++c)
      cost += cost_term(observe(s_cam + 15 * c, pv,
                                load_meas(obs_t, repr_base, depth_base, k * C + c, l, L,
                                          active)),
                        w_lm, a2r, a2d);
  }
  block_cost(cost, s_cost, part_cost);
  if (!arrive_last(counter)) return;
  grid_cost(part_cost, cost_out);
  release(counter);
}

__global__ void noop_kernel() {}

// Lets kernel fn take `bytes` of dynamic shared memory where that is over the
// default 48 KB. `allowed` is fn's own record of the cap set on each device,
// so the attribute is set once per device (and again only for a larger size).
int set_smem(const void* fn, size_t bytes, size_t (&allowed)[kDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kDevices && bytes <= allowed[dev]) return 0;
  err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err && dev < kDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

int limo_block_size() { return kThreads; }

int limo_block_landmarks() { return kTile; }

int limo_assemble_obs(const float* obs_t, const float* repr_base, const float* depth_base,
                      const float* lm_t, const float* wlm, const float* pose_mats,
                      const float* cam_mats, int K, int C, int L, float a2r, float a2d,
                      float* V, float* bl, float* W, float* U, float* bp, float* cost,
                      float* part_ub, float* part_cost, unsigned* counter, void* stream) {
  const size_t smem = sizeof(float) * (C * 15 + kTile * kStage + kWarps * kRed + kWarps);
  static size_t allowed[kDevices] = {};
  int err = set_smem((const void*)assemble_obs_kernel, smem, allowed);
  if (err) return err;
  assemble_obs_kernel<<<grid_blocks(L), kThreads, smem, (cudaStream_t)stream>>>(
      obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats, K, C, L, a2r, a2d, V, bl,
      W, U, bp, cost, part_ub, part_cost, counter);
  return (int)cudaGetLastError();
}

int limo_cost_obs(const float* obs_t, const float* repr_base, const float* depth_base,
                  const float* lm_t, const float* wlm, const float* pose_mats,
                  const float* cam_mats, int K, int C, int L, float a2r, float a2d,
                  float* cost, float* part_cost, unsigned* counter, void* stream) {
  const size_t smem = sizeof(float) * (C * 15 + kWarps);
  static size_t allowed[kDevices] = {};
  int err = set_smem((const void*)cost_obs_kernel, smem, allowed);
  if (err) return err;
  cost_obs_kernel<<<grid_blocks(L), kThreads, smem, (cudaStream_t)stream>>>(
      obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats, K, C, L, a2r, a2d, cost,
      part_cost, counter);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid of the two above: the launch floor.
int limo_noop(int L, void* stream) {
  noop_kernel<<<grid_blocks(L), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
