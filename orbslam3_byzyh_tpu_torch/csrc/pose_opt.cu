// K3: fused motion-only pose optimization (4 rounds x 10 LM iterations).
//
// Replaces orbslam3_byzyh_tpu/solver/pallas_pose_opt.py::
// pose_optimization_fused (the Pallas kernel built by _kernel_factory),
// itself the fused form of Optimizer::PoseOptimization: pinhole residuals
// and 2x6 Jacobians under a left SE(3) perturbation, Huber weights with
// delta^2 = 5.991 (dropped in the last round), the 6x6 normal equations,
// (H + lam diag H) dx = g, retraction exp(dx) * T with Gram-Schmidt
// re-orthonormalisation, accept if the cost falls (lam * 0.5) else reject
// (lam * 10), and inliers re-marked between rounds (chi2 <= 5.991 with
// depth > 0.05).
//
// K3s, the stereo variant (template flag STEREO, the same kernel): the
// mixed mono/stereo schedule of orbslam3_byzyh_tpu/solver/pose_opt.py::
// pose_optimization_stereo (EdgeStereoSE3ProjectXYZOnlyPose), which the
// JAX package runs through XLA, not Pallas. Each point also carries the
// right-image coordinate u_r (< 0 for a mono row); a stereo row adds the
// residual u_r - (u - bf / z) with Jacobian row J_u - (0, 0, e, e y, -e x,
// 0), e = bf / z^2, its chi2 sums three rows, and its Huber delta^2 and
// inlier gate are 7.815 instead of 5.991.
//
// KB8 (template flag KB8, with or without STEREO): the Kannala-Brandt
// fisheye camera (TUM-VI's) instead of the pinhole, for the JAX package's
// XLA path of the same two functions with model_id = KB8 (its
// solver/pose_opt.py:100-160 and :163; the Pallas kernel takes the pinhole
// only). The projection is ops/camera.py's kb8_project (theta = atan2(R, z),
// r(theta) = theta (1 + k0 th^2 + k1 th^4 + k2 th^6 + k3 th^8), the point on
// the axis at R < 1e-9 mapped to the principal point) and its 2x3 Jacobian
// kb8_project_jac (the squared radius guarded at 1e-12), in double, through
// [I | -skew(pc)] as the pinhole's; a stereo row keeps u_r = u - bf / z with
// u the KB8 projection. The camera then carries 8 parameters (fx, fy, cx,
// cy, k0..k3); the points take the same shared memory.
//
// What bounds it on this card: the chain of dependent steps, not bytes or
// flops. One problem is ~1k points (~30 KB, ~10 MFLOP for the schedule);
// every LM iteration needs the previous one's pose, so the time is the
// number of passes over the points times (pass + block reduction + the
// serial 6x6 solve and retraction).
//
// Design: one thread block per problem (a batch of B problems is one
// launch, each block bit-identical to its single-problem run).
//  * One pass per LM iteration. The pass at the candidate pose gives its
//    cost together with H and g there. On accept those are the next
//    iteration's system; on reject the pose and the inlier set are
//    unchanged, so the current H and g are still exact and only lam
//    changes. A round's first pass gives cost0 with H and g; from round 1
//    on it first re-marks each point's inlier flag at the same pose, and the
//    last pass writes chi2. 45 passes: 1 + 40 + 3 + 1.
//  * The points and their flags live in shared memory for the whole
//    schedule (25 B a point, 29 B with u_r); each point is owned by one thread of warps
//    1.., which alone reads and writes its flag. The pass is branch-free: a
//    point outside the mask adds zeros.
//  * The 27 H/g sums and the cost are reduced by a warp transpose-reduce:
//    each shuffle step hands half of a lane's partial sums to its partner
//    (31 shuffles a warp, after which lane k holds the warp's sum k), then
//    warp 0 adds the warps' partials, lane k for sum k, in a fixed order, so
//    runs are deterministic.
//  * Warp 0 keeps the LM state in shared memory and runs the accept test,
//    the solve (LDL^T: no square roots) and the retraction (sincosf)
//    redundantly in its 32 lanes. While warps 1.. run a candidate's pass,
//    warp 0 already solves for the step that follows a rejection (same H,
//    g and pose, lam * 10), so only an accepted candidate leaves a solve on
//    the critical path.
// The schedule's arithmetic is double precision (`real`): the points, the
// pose and the camera arrive as float32 and the results leave as float32,
// as the plain version's float64 oracle casts them; the damping stays the
// plain version's float32. In float32 the sums, the accept tests and the
// retraction drifted by up to 1.2e-4 from the oracle on the mono-inertial
// map (poses a few metres from the origin), past the 1e-4 the kernel is held
// to; the float32 plain version strayed as far (8.4e-5). Division and
// square root stay IEEE (no fast math).

#include <cuda_runtime.h>

namespace {

// The arithmetic type of the schedule (the points and poses arrive and
// leave as float32).
using real = double;

constexpr int kThreads = 384;  // warp 0 solves, warps 1-11 sweep the points
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kThreads - 32;  // warps 1.. sweep the points
constexpr real kDelta2 = 5.991;         // chi2 gate, 2 rows
constexpr real kDelta2Stereo = 7.815;   // chi2 gate, 3 rows
constexpr real kFar = 1e9;             // chi2 of a point behind the camera
constexpr unsigned char kValid = 1, kInlier = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  real fx, fy, cx, cy;
  real k0, k1, k2, k3;  // KB8 only
};

// The point arrays in dynamic shared memory (ur: the stereo variant's).
struct Points {
  float *x, *y, *z, *u, *v, *iv2, *ur;
  unsigned char* flag;
};

// Bytes a point takes in shared memory.
template <bool STEREO>
constexpr int point_bytes() {
  return STEREO ? 29 : 25;
}

// LM state, written by warp 0 only.
struct State {
  real P[12];       // accepted pose: R row-major (9), t (3)
  real C[12];       // candidate pose, the next pass's
  real R[12];       // the candidate that follows a rejection
  real Hg[27];      // H upper (21) and g sums (6) at P
  real cost;
  float lam;         // float32, as the plain version's damping tensor
};

struct Terms {
  real pcx, pcy, pcz, iz, ru, rv, rr, chi2, delta2;
  bool depth_ok, has_ur;
};

template <bool STEREO, bool KB8>
__device__ __forceinline__ Terms point_terms(const real (&pose)[12],
                                             const Cam& c, const Points& s,
                                             int i, real bf) {
  const real X = s.x[i], Y = s.y[i], Z = s.z[i];
  Terms t;
  t.pcx = pose[0] * X + pose[1] * Y + pose[2] * Z + pose[9];
  t.pcy = pose[3] * X + pose[4] * Y + pose[5] * Z + pose[10];
  t.pcz = pose[6] * X + pose[7] * Y + pose[8] * Z + pose[11];
  t.depth_ok = t.pcz > 0.05;
  t.iz = 1.0 / (t.depth_ok ? t.pcz : 1.0);
  real uhat, vhat;
  if constexpr (KB8) {
    const real rad = sqrt(t.pcx * t.pcx + t.pcy * t.pcy);
    const real th = atan2(rad, t.pcz);
    const real th2 = th * th;
    const real r =
        th * (1.0 + th2 * (c.k0 + th2 * (c.k1 + th2 * (c.k2 + th2 * c.k3))));
    const bool on_axis = rad < 1e-9;
    const real inv_r = 1.0 / (on_axis ? 1e-9 : rad);
    const real psi_cos = on_axis ? 1.0 : t.pcx * inv_r;
    const real psi_sin = on_axis ? 0.0 : t.pcy * inv_r;
    uhat = c.fx * r * psi_cos + c.cx;
    vhat = c.fy * r * psi_sin + c.cy;
  } else {
    uhat = c.fx * t.pcx * t.iz + c.cx;
    vhat = c.fy * t.pcy * t.iz + c.cy;
  }
  t.ru = s.u[i] - uhat;
  t.rv = s.v[i] - vhat;
  real sq = t.ru * t.ru + t.rv * t.rv;
  t.has_ur = false;
  t.rr = 0.0;
  if (STEREO) {
    t.has_ur = s.ur[i] >= 0.0;
    t.rr = t.has_ur ? s.ur[i] - (uhat - bf * t.iz) : 0.0;
    sq += t.rr * t.rr;
  }
  t.chi2 = sq * s.iv2[i];
  t.delta2 = t.has_ur ? kDelta2Stereo : kDelta2;
  return t;
}

// The KB8 projection's 2x3 Jacobian d(u, v) / d(pc) (kb8_project_jac).
__device__ __forceinline__ void kb8_jacobian(const Cam& c, real x, real y,
                                             real z, real (&du)[3],
                                             real (&dv)[3]) {
  const real r2 = x * x + y * y;
  const real r = sqrt(r2 < 1e-12 ? 1e-12 : r2);
  const real r3 = r2 * r;
  const real th = atan2(r, z);
  const real th2 = th * th;
  const real th4 = th2 * th2;
  const real th6 = th4 * th2;
  const real th8 = th4 * th4;
  const real f = th * (1.0 + c.k0 * th2 + c.k1 * th4 + c.k2 * th6 +
                       c.k3 * th8);
  const real fp = 1.0 + 3 * c.k0 * th2 + 5 * c.k1 * th4 + 7 * c.k2 * th6 +
                  9 * c.k3 * th8;
  const real norm2 = r2 + z * z;
  const real dth_dx = x * z / (norm2 * r);
  const real dth_dy = y * z / (norm2 * r);
  const real dth_dz = -r / norm2;
  du[0] = c.fx * (fp * dth_dx * x / r + f * y * y / r3);
  du[1] = c.fx * (fp * dth_dy * x / r - f * x * y / r3);
  du[2] = c.fx * fp * dth_dz * x / r;
  dv[0] = c.fy * (fp * dth_dx * y / r - f * x * y / r3);
  dv[1] = c.fy * (fp * dth_dy * y / r + f * x * x / r3);
  dv[2] = c.fy * fp * dth_dz * y / r;
}

// One pass of warps 1.. over the points at `pose_s` (shared): the masked
// points' 21 H and 6 g terms and Huber cost, summed into v[0..27] per
// thread (warp 0 adds nothing). REMARK first re-marks each point's inlier
// flag from its chi2 at this pose.
template <bool REMARK, bool STEREO, bool KB8>
__device__ __forceinline__ void normal_pass(const real* pose_s, const Cam& cam,
                                            const Points& s, int n, real bf,
                                            bool robust, real (&v)[32]) {
  real pose[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) pose[q] = pose_s[q];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = 0.0;
  if (threadIdx.x < 32) return;
#pragma unroll 2
  for (int i = threadIdx.x - 32; i < n; i += kWorkers) {
    const Terms t = point_terms<STEREO, KB8>(pose, cam, s, i, bf);
    unsigned char f = s.flag[i];
    if (REMARK) {
      const real chi2 = t.depth_ok ? t.chi2 : kFar;
      f = (f & kValid) && chi2 <= t.delta2 ? (kValid | kInlier)
                                           : (f & kValid);
      s.flag[i] = f;
    }
    const bool use = (f & kInlier) && t.depth_ok;   // inlier implies valid
    real w = 1.0, rho = t.chi2;
    if (robust && t.chi2 > t.delta2) {
      const real sq = sqrt(t.chi2);
      const real delta = sqrt(t.delta2);
      w = delta / sq;
      rho = 2.0 * delta * sq - t.delta2;
    }
    // A point outside the mask adds zeros (selected, so that no inf or NaN
    // of an unused point reaches the sums).
    w = use ? w * s.iv2[i] : 0.0;
    rho = use ? rho : 0.0;
    const real iz = use ? t.iz : 0.0;
    const real px = use ? t.pcx : 0.0, py = use ? t.pcy : 0.0;
    const real pz = use ? t.pcz : 0.0;
    const real ru = use ? t.ru : 0.0, rv = use ? t.rv : 0.0;
    real ju[6], jv[6];
    if constexpr (KB8) {
      // J = -d(u, v)/d(pc) [I | -skew(pc)] at the point itself; zeros
      // (selected, not multiplied) outside the mask.
      real du[3], dv[3];
      kb8_jacobian(cam, t.pcx, t.pcy, t.pcz, du, dv);
      const real x = t.pcx, y = t.pcy, z = t.pcz;
      const real u6[6] = {-du[0], -du[1], -du[2], -(-du[1] * z + du[2] * y),
                          -(du[0] * z - du[2] * x), -(-du[0] * y + du[1] * x)};
      const real v6[6] = {-dv[0], -dv[1], -dv[2], -(-dv[1] * z + dv[2] * y),
                          -(dv[0] * z - dv[2] * x), -(-dv[0] * y + dv[1] * x)};
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        ju[r] = use ? u6[r] : 0.0;
        jv[r] = use ? v6[r] : 0.0;
      }
    } else {
      const real a = cam.fx * iz;
      const real b = -cam.fx * px * iz * iz;
      const real c = cam.fy * iz;
      const real d = -cam.fy * py * iz * iz;
      const real u6[6] = {-a, 0.0, -b, -(b * py), -(a * pz - b * px), a * py};
      const real v6[6] = {0.0, -c, -d, -(-c * pz + d * py), d * px, -c * px};
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        ju[r] = u6[r];
        jv[r] = v6[r];
      }
    }
    int k = 0;
    if (STEREO) {
      // The third row, J_u - (0, 0, e, e y, -e x, 0) with e = bf / z^2;
      // zeros for a mono row.
      const bool third = use && t.has_ur;
      const real e = third ? bf * iz * iz : 0.0;
      const real on = third ? 1.0 : 0.0;
      const real rr = third ? t.rr : 0.0;
      const real jr[6] = {on * ju[0], on * ju[1], on * ju[2] - e,
                           on * ju[3] - e * py, on * ju[4] + e * px,
                           on * ju[5]};
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int q = r; q < 6; ++q)
          v[k++] += w * (ju[r] * ju[q] + jv[r] * jv[q] + jr[r] * jr[q]);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        v[21 + r] += w * (ju[r] * ru + jv[r] * rv + jr[r] * rr);
    } else {
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int q = r; q < 6; ++q)
          v[k++] += w * (ju[r] * ju[q] + jv[r] * jv[q]);
#pragma unroll
      for (int r = 0; r < 6; ++r) v[21 + r] += w * (ju[r] * ru + jv[r] * rv);
    }
    v[27] += rho;
  }
}

// One transpose-reduce step: the lane keeps the half of v[0..2*HALF) that
// its bit HALF selects, adds its partner's copy of that half, and hands
// the other half to the partner.
template <int HALF>
__device__ __forceinline__ void transpose_step(real (&v)[32], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const real send = upper ? v[j] : v[j + HALF];
    const real keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// Block sum of v[0..31]: on return (after a barrier) s_warp[w][k] holds
// warp w's sum k. Within a warp, 5 transpose-reduce steps (31 shuffles)
// leave lane l with the warp's sum of v[l].
__device__ __forceinline__ void block_partials(real (&v)[32],
                                               real (*s_warp)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  s_warp[threadIdx.x >> 5][lane] = v[0];
  __syncthreads();
}

// Warp 0, lane k: the block's sum k (warps added in a fixed order).
__device__ __forceinline__ real block_total(real (*s_warp)[32]) {
  const int lane = threadIdx.x & 31;
  real x = s_warp[0][lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x += s_warp[w][lane];
  return x;
}

// Solve (H + lam diag(H)) x = g, H symmetric positive (semi)definite, as
// L D L^T (unit L): one reciprocal per pivot and no square root on the
// chain. Pivots are clamped at 1e-12, as the Pallas kernel's Cholesky
// clamps its squared pivots (pallas_pose_opt.py:54).
__device__ __forceinline__ void ldl_solve6(real (&A)[6][6],
                                           const real (&g)[6], float lam,
                                           real (&x)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] += lam * fmax(A[i][i], 1e-9);
  real L[6][6], E[6][6], inv[6];    // E[j][i] = L[j][i] * D[i]
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    real d = A[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) d -= L[i][k] * E[i][k];
    inv[i] = 1.0 / fmax(d, 1e-12);
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      real s = A[j][i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[j][k] * E[i][k];
      E[j][i] = s;
      L[j][i] = s * inv[i];
    }
  }
  real y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    real s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    real s = y[i] * inv[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s;
  }
}

// out = exp([rho, phi]) * pose; pose = [R row-major (9), t (3)].
__device__ __forceinline__ void retract(const real (&pose)[12],
                                        const real (&dx)[6],
                                        real (&out)[12]) {
  const real wx = dx[3], wy = dx[4], wz = dx[5];
  const real th2 = wx * wx + wy * wy + wz * wz;
  const real th = sqrt(th2);
  const bool small = th < 1e-6;
  real sn, cs;
  sincos(th, &sn, &cs);
  const real ith = 1.0 / th;
  const real a = small ? 1.0 - th2 / 6.0 : sn * ith;
  const real b = small ? 0.5 - th2 / 24.0 : (1.0 - cs) * ith * ith;
  const real c = small ? 1.0 / 6.0 - th2 / 120.0
                        : (th - sn) * ith * ith * ith;
  const real W[3][3] = {{0.0, -wz, wy}, {wz, 0.0, -wx}, {-wy, wx, 0.0}};
  real dR[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      real w2 = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2 += W[i][k] * W[k][j];
      const real e = i == j ? 1.0 : 0.0;
      dR[i][j] = e + a * W[i][j] + b * w2;   // so3_exp(phi)
      V[i][j] = e + b * W[i][j] + c * w2;    // left Jacobian of phi
    }
  real Rn[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      real s = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) s += dR[i][k] * pose[3 * k + j];
      Rn[i][j] = s;
    }
  // Gram-Schmidt on the rows; the third row is the cross product (det +1).
  const real i0 = 1.0 / sqrt(fmax(Rn[0][0] * Rn[0][0] +
                                      Rn[0][1] * Rn[0][1] +
                                      Rn[0][2] * Rn[0][2], 1e-18));
  const real r0[3] = {Rn[0][0] * i0, Rn[0][1] * i0, Rn[0][2] * i0};
  const real d = Rn[1][0] * r0[0] + Rn[1][1] * r0[1] + Rn[1][2] * r0[2];
  real r1[3] = {Rn[1][0] - d * r0[0], Rn[1][1] - d * r0[1],
                 Rn[1][2] - d * r0[2]};
  const real i1 = 1.0 / sqrt(fmax(r1[0] * r1[0] + r1[1] * r1[1] +
                                      r1[2] * r1[2], 1e-18));
#pragma unroll
  for (int i = 0; i < 3; ++i) r1[i] *= i1;
  const real r2[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                       r0[2] * r1[0] - r0[0] * r1[2],
                       r0[0] * r1[1] - r0[1] * r1[0]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = r0[j];
    out[3 + j] = r1[j];
    out[6 + j] = r2[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    real s = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) s += dR[i][k] * pose[9 + k];
    out[9 + i] = s;
  }
}

// Warp 0: the step from pose st.P with the system st.Hg damped by `lam`,
// written to `out` (shared) by lane 0.
__device__ __forceinline__ void propose(const State& st, float lam,
                                        real* out) {
  real A[6][6], g[6], dx[6], P[12], C[12];
  int k = 0;
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int q = r; q < 6; ++q) {
      A[r][q] = st.Hg[k];
      A[q][r] = st.Hg[k];
      ++k;
    }
#pragma unroll
  for (int r = 0; r < 6; ++r) g[r] = -st.Hg[21 + r];
#pragma unroll
  for (int q = 0; q < 12; ++q) P[q] = st.P[q];
  ldl_solve6(A, g, lam, dx);
  retract(P, dx, C);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 12; ++q) out[q] = C[q];
  }
}

template <bool STEREO, bool KB8>
__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                const float* __restrict__ cam_params,
                const float* __restrict__ pts, const float* __restrict__ obs,
                const float* __restrict__ obs_ur, real bf,
                const float* __restrict__ inv_s2,
                const bool* __restrict__ valid, int n, int n_rounds,
                int n_iters, float* __restrict__ R_out,
                float* __restrict__ t_out, float* __restrict__ chi2_out) {
  extern __shared__ float s_dyn[];
  __shared__ real s_warp[kWarps][32];
  __shared__ State st;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool warp0 = tid < 32;
  const size_t b = blockIdx.x;
  const int n_arrays = STEREO ? 7 : 6;
  const Points s = {s_dyn, s_dyn + n, s_dyn + 2 * n, s_dyn + 3 * n,
                    s_dyn + 4 * n, s_dyn + 5 * n, s_dyn + 6 * n,
                    reinterpret_cast<unsigned char*>(s_dyn + n_arrays * n)};
  const Cam cam = {cam_params[0], cam_params[1], cam_params[2],
                   cam_params[3], KB8 ? cam_params[4] : 0.0f,
                   KB8 ? cam_params[5] : 0.0f, KB8 ? cam_params[6] : 0.0f,
                   KB8 ? cam_params[7] : 0.0f};
  pts += b * n * 3;
  obs += b * n * 2;
  inv_s2 += b * n;
  valid += b * n;
  if (STEREO) obs_ur += b * n;
  for (int i = tid; i < n; i += kThreads) {
    s.x[i] = pts[3 * i];
    s.y[i] = pts[3 * i + 1];
    s.z[i] = pts[3 * i + 2];
    s.u[i] = obs[2 * i];
    s.v[i] = obs[2 * i + 1];
    s.iv2[i] = inv_s2[i];
    if (STEREO) s.ur[i] = obs_ur[i];
    s.flag[i] = valid[i] ? (kValid | kInlier) : 0;
  }
  if (tid < 9) st.P[tid] = R0[b * 9 + tid];
  if (tid < 3) st.P[9 + tid] = t0[b * 3 + tid];
  __syncthreads();

  real v[32];
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < n_rounds - 1;
    // The round's first pass, at the accepted pose: cost0, H and g. From
    // round 1 on it first re-marks the inliers at that pose.
    if (rnd == 0)
      normal_pass<false, STEREO, KB8>(st.P, cam, s, n, bf, robust, v);
    else
      normal_pass<true, STEREO, KB8>(st.P, cam, s, n, bf, robust, v);
    block_partials(v, s_warp);
    if (warp0) {
      const real x = block_total(s_warp);
      if (lane < 27) st.Hg[lane] = x;
      if (lane == 27) st.cost = x;
      if (lane == 0) st.lam = 1e-3f;
      __syncwarp();
      if (n_iters > 0) propose(st, 1e-3f, st.C);
    }

    for (int it = 0; it < n_iters; ++it) {
      const bool more = it + 1 < n_iters;
      __syncthreads();
      // The candidate's pass; meanwhile warp 0 solves for the step that
      // follows a rejection.
      if (warp0 && more) propose(st, st.lam * 10.0f, st.R);
      normal_pass<false, STEREO, KB8>(st.C, cam, s, n, bf, robust, v);
      block_partials(v, s_warp);
      if (warp0) {
        const real x = block_total(s_warp);
        const real cost = __shfl_sync(kFull, x, 27);
        const bool accept = cost < st.cost;
        const float lam = st.lam * (accept ? 0.5f : 10.0f);
        __syncwarp();
        if (accept) {
          if (lane < 27) st.Hg[lane] = x;
          if (lane < 12) st.P[lane] = st.C[lane];
          if (lane == 0) st.cost = cost;
        } else if (lane < 12) {
          st.C[lane] = st.R[lane];
        }
        if (lane == 0) st.lam = lam;
        __syncwarp();
        if (accept && more) propose(st, lam, st.C);
      }
    }
    __syncthreads();
  }

  chi2_out += b * n;
  real pose[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) pose[q] = st.P[q];
  for (int i = tid; i < n; i += kThreads) {
    const Terms t = point_terms<STEREO, KB8>(pose, cam, s, i, bf);
    chi2_out[i] = t.depth_ok ? t.chi2 : kFar;
  }
  if (tid < 9) R_out[b * 9 + tid] = st.P[tid];
  if (tid < 3) t_out[b * 3 + tid] = st.P[9 + tid];
}

// Shared memory beside the points: the warp partials and the LM state.
constexpr int kStaticSmem = (int)(sizeof(real) * kWarps * 32 + sizeof(State));

template <bool STEREO>
int max_points() {
  return (232448 - kStaticSmem) / point_bytes<STEREO>();
}

template <bool STEREO, bool KB8>
int launch_model(const float* R0, const float* t0, const float* cam_params,
                 const float* pts, const float* obs, const float* obs_ur,
                 float bf, const float* inv_s2, const bool* valid, int b,
                 int n, int n_rounds, int n_iters, float* R_out, float* t_out,
                 float* chi2_out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (n < 0 || n > max_points<STEREO>()) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * point_bytes<STEREO>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_opt_kernel<STEREO, KB8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pose_opt_kernel<STEREO, KB8><<<b, kThreads, smem, stream>>>(
      R0, t0, cam_params, pts, obs, obs_ur, bf, inv_s2, valid, n, n_rounds,
      n_iters, R_out, t_out, chi2_out);
  return (int)cudaGetLastError();
}

// The camera models of ops/camera.py.
constexpr int kPinhole = 0, kKb8 = 1;

template <bool STEREO>
int launch(const float* R0, const float* t0, const float* cam_params,
           const float* pts, const float* obs, const float* obs_ur, float bf,
           const float* inv_s2, const bool* valid, int b, int n,
           int n_rounds, int n_iters, float* R_out, float* t_out,
           float* chi2_out, int model_id, cudaStream_t stream) {
  if (model_id == kPinhole)
    return launch_model<STEREO, false>(R0, t0, cam_params, pts, obs, obs_ur,
                                       bf, inv_s2, valid, b, n, n_rounds,
                                       n_iters, R_out, t_out, chi2_out,
                                       stream);
  if (model_id == kKb8)
    return launch_model<STEREO, true>(R0, t0, cam_params, pts, obs, obs_ur,
                                      bf, inv_s2, valid, b, n, n_rounds,
                                      n_iters, R_out, t_out, chi2_out,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Points held in shared memory: 25 bytes each (29 with u_r), within the
// 227 KB a block may use beside its static shared memory.
extern "C" int pose_max_points() { return max_points<false>(); }

extern "C" int pose_max_points_stereo() { return max_points<true>(); }

// model_id: 0 the pinhole (cam_params fx, fy, cx, cy), 1 KB8 (fx, fy, cx,
// cy, k0, k1, k2, k3).
extern "C" int pose_optimization(const float* R0, const float* t0,
                                 const float* cam_params, const float* pts,
                                 const float* obs, const float* inv_s2,
                                 const bool* valid, int b, int n, int n_rounds,
                                 int n_iters, float* R_out, float* t_out,
                                 float* chi2_out, int model_id,
                                 cudaStream_t stream) {
  return launch<false>(R0, t0, cam_params, pts, obs, nullptr, 0.0f, inv_s2,
                       valid, b, n, n_rounds, n_iters, R_out, t_out, chi2_out,
                       model_id, stream);
}

extern "C" int pose_optimization_stereo(
    const float* R0, const float* t0, const float* cam_params,
    const float* pts, const float* obs, const float* obs_ur, float bf,
    const float* inv_s2, const bool* valid, int b, int n, int n_rounds,
    int n_iters, float* R_out, float* t_out, float* chi2_out, int model_id,
    cudaStream_t stream) {
  return launch<true>(R0, t0, cam_params, pts, obs, obs_ur, bf, inv_s2,
                      valid, b, n, n_rounds, n_iters, R_out, t_out, chi2_out,
                      model_id, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
