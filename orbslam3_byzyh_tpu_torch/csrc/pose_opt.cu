// K3: fused motion-only pose optimization (4 rounds x 10 LM iterations).
//
// Replaces orbslam3_byzyh_tpu/solver/pallas_pose_opt.py::
// pose_optimization_fused (the Pallas kernel built by _kernel_factory),
// itself the fused form of Optimizer::PoseOptimization: pinhole residuals
// and 2x6 Jacobians under a left SE(3) perturbation, Huber weights with
// delta^2 = 5.991 (dropped in the last round), the 6x6 normal equations,
// (H + lam diag H) dx = g by scalar Cholesky, retraction exp(dx) * T with
// Gram-Schmidt re-orthonormalisation, accept if the cost falls (lam * 0.5)
// else reject (lam * 10), and inliers re-marked between rounds
// (chi2 <= 5.991 with depth > 0.05).
//
// What bounds it on this card: the sequential chain, not bytes or flops.
// One problem is ~1k points; each of the 40 iterations is two passes over
// them (normal equations, candidate cost) with a tiny 6x6 solve between,
// so the cost is ~90 block-wide reductions and barriers in a row. Launched
// from the host, each step would be a separate small kernel.
//
// Design: one thread block per problem (a batch of B problems is one
// launch). The points stay in global memory (28 bytes each, L1/L2
// resident); each thread owns the points i = tid (mod blockDim) for the
// whole schedule, so its inlier flags in the scratch buffer are written and
// read by the same thread. Each pass ends in a block reduction (warp
// shuffles, then one value per warp through shared memory) of the 21 upper
// H entries, 6 g entries and the cost. Thread 0 then runs the Cholesky
// solve, the retraction and the accept test on scalars and publishes the
// pose through shared memory. Sums are taken in a fixed order, so a run is
// deterministic; the order differs from the plain PyTorch version's, which
// also uses SVD and linalg.solve, so the two agree to a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;            // 21 H (upper) + 6 g + 1 cost
constexpr float kDelta2 = 5.991f;

struct Cam {
  float fx, fy, cx, cy;
};

struct Terms {
  float pcx, pcy, pcz, iz, ru, rv, chi2;
  bool depth_ok;
};

__device__ __forceinline__ Terms point_terms(const float* pose, const Cam& c,
                                             const float* p, const float* o,
                                             float iv2) {
  Terms t;
  t.pcx = pose[0] * p[0] + pose[1] * p[1] + pose[2] * p[2] + pose[9];
  t.pcy = pose[3] * p[0] + pose[4] * p[1] + pose[5] * p[2] + pose[10];
  t.pcz = pose[6] * p[0] + pose[7] * p[1] + pose[8] * p[2] + pose[11];
  t.depth_ok = t.pcz > 0.05f;
  t.iz = 1.0f / (t.depth_ok ? t.pcz : 1.0f);
  t.ru = o[0] - (c.fx * t.pcx * t.iz + c.cx);
  t.rv = o[1] - (c.fy * t.pcy * t.iz + c.cy);
  t.chi2 = (t.ru * t.ru + t.rv * t.rv) * iv2;
  return t;
}

__device__ __forceinline__ float huber_rho(float chi2, bool robust) {
  if (!robust || chi2 <= kDelta2) return chi2;
  return 2.0f * sqrtf(kDelta2 * chi2) - kDelta2;
}

// Sums v[0..N) over the block into out[0..N) (shared); all threads call it.
template <int N>
__device__ void block_sum(float (&v)[N], float (*s_warp)[kSums], float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_warp[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float x = 0.0f;
    for (int w = 0; w < kWarps; ++w) x += s_warp[w][threadIdx.x];
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// Solve (H + lam diag(H)) x = g, H symmetric positive (semi)definite.
__device__ void chol_solve6(float (&A)[6][6], const float (&g)[6], float lam,
                            float (&x)[6]) {
  for (int i = 0; i < 6; ++i) A[i][i] += lam * fmaxf(A[i][i], 1e-9f);
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    float s = A[i][i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    const float lii = sqrtf(fmaxf(s, 1e-12f));
    L[i][i] = lii;
    const float inv = 1.0f / lii;
    for (int j = i + 1; j < 6; ++j) {
      float s2 = A[j][i];
      for (int k = 0; k < i; ++k) s2 -= L[j][k] * L[i][k];
      L[j][i] = s2 * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// pose' = exp([rho, phi]) * pose; pose = [R row-major (9), t (3)].
__device__ void retract(const float* pose, const float (&dx)[6],
                        float* out) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(th2);
  const bool small = th < 1e-6f;
  const float a = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
  const float c = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sinf(th)) / (th2 * th);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float dR[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.0f;
      for (int k = 0; k < 3; ++k) w2 += W[i][k] * W[k][j];
      const float e = i == j ? 1.0f : 0.0f;
      dR[i][j] = e + a * W[i][j] + b * w2;   // so3_exp(phi)
      V[i][j] = e + b * W[i][j] + c * w2;    // left Jacobian of phi
    }
  float Rn[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
      for (int k = 0; k < 3; ++k) s += dR[i][k] * pose[3 * k + j];
      Rn[i][j] = s;
    }
  // Gram-Schmidt on the rows; the third row is the cross product (det +1).
  float n0 = sqrtf(fmaxf(Rn[0][0] * Rn[0][0] + Rn[0][1] * Rn[0][1] +
                         Rn[0][2] * Rn[0][2], 1e-18f));
  float r0[3] = {Rn[0][0] / n0, Rn[0][1] / n0, Rn[0][2] / n0};
  const float d = Rn[1][0] * r0[0] + Rn[1][1] * r0[1] + Rn[1][2] * r0[2];
  float r1[3] = {Rn[1][0] - d * r0[0], Rn[1][1] - d * r0[1],
                 Rn[1][2] - d * r0[2]};
  const float n1 = sqrtf(fmaxf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2],
                               1e-18f));
  for (int i = 0; i < 3; ++i) r1[i] /= n1;
  const float r2[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                       r0[2] * r1[0] - r0[0] * r1[2],
                       r0[0] * r1[1] - r0[1] * r1[0]};
  for (int j = 0; j < 3; ++j) {
    out[j] = r0[j];
    out[3 + j] = r1[j];
    out[6 + j] = r2[j];
  }
  for (int i = 0; i < 3; ++i) {
    float s = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
    for (int k = 0; k < 3; ++k) s += dR[i][k] * pose[9 + k];
    out[9 + i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ params,
                const float* __restrict__ pts, const float* __restrict__ obs,
                const float* __restrict__ inv_s2,
                const bool* __restrict__ valid,
                unsigned char* __restrict__ inlier, int n, int n_rounds,
                int n_iters, float* __restrict__ pose_out,
                float* __restrict__ chi2_out) {
  __shared__ float s_pose[12];
  __shared__ float s_cand[12];
  __shared__ float s_warp[kWarps][kSums];
  __shared__ float s_sum[kSums];
  __shared__ float s_lam;
  __shared__ float s_cost;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n;
  pts += base * 3;
  obs += base * 2;
  inv_s2 += base;
  valid += base;
  inlier += base;
  chi2_out += base;
  const float* prm = params + (size_t)blockIdx.x * 16;
  const Cam cam = {prm[12], prm[13], prm[14], prm[15]};
  if (tid < 12) s_pose[tid] = prm[tid];
  for (int i = tid; i < n; i += kThreads) inlier[i] = valid[i];
  __syncthreads();

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < n_rounds - 1;

    float c0[1] = {0.0f};
    for (int i = tid; i < n; i += kThreads) {
      const Terms t = point_terms(s_pose, cam, pts + 3 * i, obs + 2 * i,
                                  inv_s2[i]);
      if (inlier[i] && valid[i] && t.depth_ok) c0[0] += huber_rho(t.chi2, robust);
    }
    block_sum<1>(c0, s_warp, s_sum);
    if (tid == 0) {
      s_cost = s_sum[0];
      s_lam = 1e-3f;
    }

    for (int it = 0; it < n_iters; ++it) {
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += kThreads) {
        const float iv2 = inv_s2[i];
        const Terms t = point_terms(s_pose, cam, pts + 3 * i, obs + 2 * i,
                                    iv2);
        if (!(inlier[i] && valid[i] && t.depth_ok)) continue;
        const float w_rob = (!robust || t.chi2 <= kDelta2)
                                ? 1.0f
                                : sqrtf(kDelta2 / fmaxf(t.chi2, 1e-12f));
        const float w = w_rob * iv2;
        const float a = cam.fx * t.iz;
        const float b = -cam.fx * t.pcx * t.iz * t.iz;
        const float c = cam.fy * t.iz;
        const float d = -cam.fy * t.pcy * t.iz * t.iz;
        const float ju[6] = {-a, 0.0f, -b, -(b * t.pcy),
                             -(a * t.pcz - b * t.pcx), a * t.pcy};
        const float jv[6] = {0.0f, -c, -d, -(-c * t.pcz + d * t.pcy),
                             d * t.pcx, -c * t.pcx};
        int k = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int q = r; q < 6; ++q)
            acc[k++] += w * (ju[r] * ju[q] + jv[r] * jv[q]);
#pragma unroll
        for (int r = 0; r < 6; ++r)
          acc[21 + r] += w * (ju[r] * t.ru + jv[r] * t.rv);
        acc[27] += huber_rho(t.chi2, robust);
      }
      block_sum<kSums>(acc, s_warp, s_sum);

      if (tid == 0) {
        float H[6][6], g[6], dx[6];
        int k = 0;
        for (int r = 0; r < 6; ++r)
          for (int q = r; q < 6; ++q) {
            H[r][q] = s_sum[k];
            H[q][r] = s_sum[k];
            ++k;
          }
        for (int r = 0; r < 6; ++r) g[r] = -s_sum[21 + r];
        chol_solve6(H, g, s_lam, dx);
        retract(s_pose, dx, s_cand);
      }
      __syncthreads();

      float cn[1] = {0.0f};
      for (int i = tid; i < n; i += kThreads) {
        const Terms t = point_terms(s_cand, cam, pts + 3 * i, obs + 2 * i,
                                    inv_s2[i]);
        if (inlier[i] && valid[i] && t.depth_ok) cn[0] += huber_rho(t.chi2, robust);
      }
      block_sum<1>(cn, s_warp, s_sum);
      if (tid == 0) {
        if (s_sum[0] < s_cost) {
          for (int q = 0; q < 12; ++q) s_pose[q] = s_cand[q];
          s_cost = s_sum[0];
          s_lam *= 0.5f;
        } else {
          s_lam *= 10.0f;
        }
      }
      __syncthreads();
    }

    // Re-classify inliers for the next round.
    for (int i = tid; i < n; i += kThreads) {
      const Terms t = point_terms(s_pose, cam, pts + 3 * i, obs + 2 * i,
                                  inv_s2[i]);
      const float chi2 = t.depth_ok ? t.chi2 : 1e9f;
      inlier[i] = chi2 <= kDelta2 && valid[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) {
    const Terms t = point_terms(s_pose, cam, pts + 3 * i, obs + 2 * i,
                                inv_s2[i]);
    chi2_out[i] = t.depth_ok ? t.chi2 : 1e9f;
  }
  if (tid < 12) pose_out[(size_t)blockIdx.x * 12 + tid] = s_pose[tid];
}

}  // namespace

extern "C" int pose_optimization(const float* params, const float* pts,
                                 const float* obs, const float* inv_s2,
                                 const bool* valid, unsigned char* inlier,
                                 int b, int n, int n_rounds, int n_iters,
                                 float* pose_out, float* chi2_out,
                                 cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  pose_opt_kernel<<<b, kThreads, 0, stream>>>(params, pts, obs, inv_s2, valid,
                                              inlier, n, n_rounds, n_iters,
                                              pose_out, chi2_out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
