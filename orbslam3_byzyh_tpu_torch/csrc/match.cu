// K2: fused masked-Hamming top-2 matcher (window / epipolar / no gate).
//
// Replaces orbslam3_byzyh_tpu/ops/pallas_match.py::hamming_best2_pallas (the
// Pallas _kernel): XOR-popcount over 8 words, the geometric gate computed
// inline, and a per-row (best, second, best column) reduction, so the
// (N, M) distance matrix never reaches device memory.
//
// What bounds it on this card: integer issue rate and latency, not bytes.
// On the tracking step N = 4096 landmarks x M = 1024 keypoints is 4M pairs
// of 8 xor + 8 popc + a gate; the inputs are ~200 KB.
//
// Design: a block holds 32 query rows x 8 column lanes (256 threads). The
// target words, validity and gate data are staged through shared memory in
// column tiles, stored word-major so the 8 lanes of a row read 8
// consecutive columns without bank conflicts. Each thread keeps its own
// (best, second, best_j) in registers over the columns j = lane (mod 8),
// visited in increasing order; the 8 partial results of a row are then
// merged with shuffles. With 8 lanes per row, N = 4096 rows fill 128 blocks,
// about one per SM, where one thread per row would leave most SMs idle.
//
// Tie rule (pallas_match.py:71-79): the lowest column wins; "second"
// excludes only the best column, so it equals "best" when a duplicate
// distance sits in another column. The per-thread update (strict < for the
// best, then < for the second) and the merge (lexicographic on
// (distance, column); second = min(winner's second, loser's best)) keep it.
//
// Exactness: the window gate du*du + dv*dv <= r^2 and the epipolar
// numerator are written with __fmul_rn/__fadd_rn/__fsub_rn so nvcc cannot
// contract them into FMAs; boundary pairs then fall the same way as in the
// plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = 1024;
constexpr int kLanes = 8;        // threads per query row
constexpr int kRows = 32;        // query rows per block
constexpr int kTile = 256;       // columns staged per shared-memory tile

enum Mode { kNone = 0, kWindow = 1, kEpipolar = 2 };

template <int MODE>
__global__ void __launch_bounds__(kLanes * kRows)
match_kernel(const int* __restrict__ da, const int* __restrict__ db,
             const bool* __restrict__ va, const bool* __restrict__ vb,
             const float* __restrict__ geo_a, const float* __restrict__ geo_b,
             int n, int m, float lvl_lo, float lvl_hi,
             int* __restrict__ best_out, int* __restrict__ second_out,
             int* __restrict__ bj_out) {
  __shared__ int s_db[8][kTile];
  __shared__ float s_gb[3][kTile];
  __shared__ bool s_vb[kTile];

  const int lane = threadIdx.x;                 // column lane 0..7
  const int tid = threadIdx.y * kLanes + lane;
  const int row = blockIdx.x * kRows + threadIdx.y;
  const bool row_ok = row < n && va[row];

  int a[8];
  float ga[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = row_ok ? da[row * 8 + k] : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) ga[k] = row_ok ? geo_a[row * 4 + k] : 0.0f;

  int best = kInvalid, second = kInvalid, bj = 0;
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int cnt = min(kTile, m - j0);
    for (int i = tid; i < cnt; i += kLanes * kRows) {
#pragma unroll
      for (int k = 0; k < 8; ++k) s_db[k][i] = db[(j0 + i) * 8 + k];
#pragma unroll
      for (int r = 0; r < 3; ++r) s_gb[r][i] = geo_b[r * m + j0 + i];
      s_vb[i] = vb[j0 + i];
    }
    __syncthreads();
    if (row_ok) {
      for (int i = lane; i < cnt; i += kLanes) {
        if (!s_vb[i]) continue;
        if (MODE == kWindow) {
          const float du = __fsub_rn(ga[0], s_gb[0][i]);
          const float dv = __fsub_rn(ga[1], s_gb[1][i]);
          const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
          const float ldiff = __fsub_rn(s_gb[2][i], ga[3]);
          if (!(d2 <= ga[2] && ldiff >= lvl_lo && ldiff <= lvl_hi)) continue;
        } else if (MODE == kEpipolar) {
          const float num = __fadd_rn(
              __fadd_rn(__fmul_rn(ga[0], s_gb[0][i]),
                        __fmul_rn(ga[1], s_gb[1][i])), ga[2]);
          const float d2 = __fmul_rn(__fmul_rn(num, num), ga[3]);
          if (!(d2 < s_gb[2][i])) continue;
        }
        int d = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) d += __popc(a[k] ^ s_db[k][i]);
        if (d < best) {
          second = best;
          best = d;
          bj = j0 + i;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();
  }

  // Merge the 8 lanes of each row (aligned groups of 8 within the warp).
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    const bool mine = best < ob || (best == ob && bj < oj);
    second = mine ? min(second, ob) : min(os, best);
    best = mine ? best : ob;
    bj = mine ? bj : oj;
  }
  if (lane == 0 && row < n) {
    best_out[row] = best;
    second_out[row] = second;
    bj_out[row] = bj;
  }
}

template <int MODE>
void launch(const int* da, const int* db, const bool* va, const bool* vb,
            const float* geo_a, const float* geo_b, int n, int m, float lo,
            float hi, int* best, int* second, int* bj, cudaStream_t stream) {
  const dim3 block(kLanes, kRows);
  const int blocks = (n + kRows - 1) / kRows;
  match_kernel<MODE><<<blocks, block, 0, stream>>>(
      da, db, va, vb, geo_a, geo_b, n, m, lo, hi, best, second, bj);
}

}  // namespace

extern "C" int hamming_best2(const int* da, const int* db, const bool* va,
                             const bool* vb, const float* geo_a,
                             const float* geo_b, int n, int m, int mode,
                             float lo, float hi, int* best, int* second,
                             int* bj, cudaStream_t stream) {
  switch (mode) {
    case kNone:
      launch<kNone>(da, db, va, vb, geo_a, geo_b, n, m, lo, hi, best, second,
                    bj, stream);
      break;
    case kWindow:
      launch<kWindow>(da, db, va, vb, geo_a, geo_b, n, m, lo, hi, best,
                      second, bj, stream);
      break;
    case kEpipolar:
      launch<kEpipolar>(da, db, va, vb, geo_a, geo_b, n, m, lo, hi, best,
                        second, bj, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
