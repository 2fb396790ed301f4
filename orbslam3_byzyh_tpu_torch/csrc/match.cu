// K2: fused masked-Hamming top-2 matcher (window / epipolar / no gate).
//
// Replaces orbslam3_byzyh_tpu/ops/pallas_match.py::hamming_best2_pallas (the
// Pallas _kernel): the Hamming distance over 256-bit descriptors, the
// geometric gate computed inline, and a per-row (best, second, best column)
// reduction, so the (N, M) distance matrix never reaches device memory.
//
// What bounds it on this card: latency and instruction issue, not bytes.
// On the tracking step N = 4096 landmarks x M = 1024 keypoints is 4M pairs
// and ~300 KB of input; every pair needs its gate, and the pairs that pass
// it their distance. As XOR + popcount on the CUDA cores the distances
// alone would be 33.5M popc at 16 a clock per SM; here they go to the
// tensor cores.
//
// Design: the distance is d = popc(a) + popc(b) - 2 popc(a AND b). One
// mma.sync.m16n8k256.b1.and.popc (BMMA in the SASS) takes the whole
// 256-bit descriptors of 16 rows against 8 columns: a thread's fragment
// registers are descriptor words t and t + 4 (t = lane % 4) as they lie in
// memory, so nothing is expanded. A block holds 16 query rows (their A
// fragments and popcounts stay in registers) and stages the columns' words,
// popcounts, validity and gate data in shared memory, up to 1024 columns at
// a time; its 8 warps split the columns in tiles of 8, so N = 4096 gives 256
// blocks. The gate runs first, branch-free, on the accumulator fragment's
// positions (two rows x two columns a thread); a tile none of whose 128
// pairs passes skips its mma (in the window mode of the tracking step, most
// tiles). The epilogue keeps a running (best, second, best_j) per row over
// the thread's columns in increasing order. The 4 lanes of a row and then
// the 8 warps are merged with the rule below.
//
// Tie rule (pallas_match.py:71-79): the lowest column wins; "second"
// excludes only the best column, so it equals "best" when a duplicate
// distance sits in another column. The per-thread update (strict < for the
// best, then < for the second) and the merge (lexicographic on
// (distance, column); second = min(winner's second, loser's best)) keep it
// for any partition of the columns. A masked pair counts INVALID (1024), so
// a row without candidates ends with best = second = 1024 and best_j = 0.
//
// Exactness: the distances are integer. The window gate du*du + dv*dv <= r^2
// and the epipolar (a u + b v + c)^2 / max(a^2 + b^2, 1e-12) < th are
// written with __fmul_rn/__fadd_rn/__fsub_rn and an IEEE division, so nvcc
// cannot contract them into FMAs; boundary pairs then fall the same way as
// in the plain PyTorch version, whose every op rounds on its own.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kInvalid = 1024;
constexpr int kWarps = 8;
constexpr int kRows = 16;        // query rows per block: one m16 tile
constexpr int kCols = 8;         // columns per mma tile (n8)
constexpr int kChunk = 1024;     // columns staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kNone = 0, kWindow = 1, kEpipolar = 2 };

}  // namespace

// The gate's inputs, as the caller holds them (passed by value).
struct Gates {
  const float* xy_a;     // (N, 2)                  window
  const float* radius;   // (N,), or one value      window
  const int* level_a;    // (N,)                    window
  const float* lines;    // (N, 3)                  epipolar
  const float* xy_b;     // (M, 2)                  window, epipolar
  const int* level_b;    // (M,)                    window
  const float* line_th;  // (M,)                    epipolar
  int radius_stride;     // 1: a radius per row; 0: one radius
  int lo, hi;            // level_b - level_a in [lo, hi]
};

namespace {

struct Top2 {
  int best, second, bj;
};

__device__ __forceinline__ void push(Top2& r, int d, int j) {
  if (d < r.best) {
    r.second = r.best;
    r.best = d;
    r.bj = j;
  } else if (d < r.second) {
    r.second = d;
  }
}

// r <- the top-2 of the union of two disjoint column sets.
__device__ __forceinline__ void merge(Top2& r, const Top2& o) {
  const bool mine = r.best < o.best || (r.best == o.best && r.bj < o.bj);
  r.second = mine ? min(r.second, o.best) : min(o.second, r.best);
  r.best = mine ? r.best : o.best;
  r.bj = mine ? r.bj : o.bj;
}

// c += popc(A AND B) over k = 256 bits on the tensor cores: A 16 x 256
// (row), B 256 x 8 (col), one bit an element.
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_words(const int* d, int row, bool ok,
                                           uint32_t (&w)[8]) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (ok) {
    const uint4* p = reinterpret_cast<const uint4*>(d + 8 * (size_t)row);
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// The staged columns, in dynamic shared memory (kChunk of each).
struct Cols {
  uint32_t (*words)[8];  // word k of column c at k ^ (4 * ((c >> 2) & 1)),
                         // so the 8 columns of a tile read distinct banks
  float *u, *v, *c;      // xy_b; level_b (as int bits) or line_th
  int* pop;              // popcount of the column's descriptor
  unsigned char* ok;     // valid_b
};

// Columns a block stages for M columns: up to kChunk, rounded up to whole
// tiles (which keeps every array 8-byte aligned).
__host__ __device__ constexpr int chunk_cap(int m) {
  return ((m < kChunk ? m : kChunk) + kCols - 1) / kCols * kCols;
}

__host__ __device__ constexpr size_t cols_bytes(int cap) {
  return (size_t)cap * (32 + 4 + 4 + 4 + 4 + 1);
}

template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
match_kernel(const int* __restrict__ da, const int* __restrict__ db,
             const bool* __restrict__ va, const bool* __restrict__ vb, int n,
             int m, const Gates gt, int* __restrict__ best_out,
             int* __restrict__ second_out, int* __restrict__ bj_out) {
  extern __shared__ uint4 s_dyn[];
  __shared__ Top2 s_part[kWarps][kRows];
  const int cap = chunk_cap(m);
  Cols s;
  s.words = reinterpret_cast<uint32_t(*)[8]>(s_dyn);
  s.u = reinterpret_cast<float*>(s.words + cap);
  s.v = s.u + cap;
  s.c = s.v + cap;
  s.pop = reinterpret_cast<int*>(s.c + cap);
  s.ok = reinterpret_cast<unsigned char*>(s.pop + cap);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;           // fragment row group
  const int t = lane & 3;            // thread in the group
  const int row0 = blockIdx.x * kRows;

  // Rows g and g + 8 of the block: the A fragment (words t and t + 4 of
  // each), popcounts, validity and gate data.
  uint32_t a[4];
  int pa[2];
  bool row_ok[2];
  float ga[2][4];  // window: u, v, r^2; epipolar: a, b, c, 1/(a^2+b^2)
  int la[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool in = row < n;
    row_ok[r] = in && va[row];
    uint32_t w[8];
    load_words(da, row, in, w);
    a[r] = in ? (uint32_t)da[8 * (size_t)row + t] : 0u;
    a[2 + r] = in ? (uint32_t)da[8 * (size_t)row + t + 4] : 0u;
    pa[r] = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) pa[r] += __popc(w[k]);
    la[r] = 0;
    ga[r][0] = ga[r][1] = ga[r][2] = ga[r][3] = 0.0f;
    if (MODE == kWindow && in) {
      const float rad = gt.radius[(size_t)row * gt.radius_stride];
      ga[r][0] = gt.xy_a[2 * (size_t)row];
      ga[r][1] = gt.xy_a[2 * (size_t)row + 1];
      ga[r][2] = __fmul_rn(rad, rad);
      la[r] = gt.level_a[row];
    } else if (MODE == kEpipolar && in) {
      const float l0 = gt.lines[3 * (size_t)row];
      const float l1 = gt.lines[3 * (size_t)row + 1];
      float n2 = __fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1));
      n2 = n2 < 1e-12f ? 1e-12f : n2;
      ga[r][0] = l0;
      ga[r][1] = l1;
      ga[r][2] = gt.lines[3 * (size_t)row + 2];
      ga[r][3] = 1.0f / n2;
    }
  }
  const int swz = 4 * ((g >> 2) & 1);   // this lane's column's word swizzle

  Top2 top[2] = {{kInvalid, kInvalid, 0}, {kInvalid, kInvalid, 0}};
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cnt = min(kChunk, m - c0);
    __syncthreads();                     // the previous chunk is consumed
#pragma unroll 4
    for (int i = threadIdx.x; i < cnt; i += kWarps * 32) {
      const int j = c0 + i;
      uint32_t w[8];
      load_words(db, j, true, w);
      int pop = 0;
      const int sw = 4 * ((i >> 2) & 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s.words[i][k ^ sw] = w[k];
        pop += __popc(w[k]);
      }
      s.pop[i] = pop;
      s.ok[i] = vb[j];
      s.u[i] = MODE != kNone ? gt.xy_b[2 * (size_t)j] : 0.0f;
      s.v[i] = MODE != kNone ? gt.xy_b[2 * (size_t)j + 1] : 0.0f;
      s.c[i] = MODE == kWindow ? __int_as_float(gt.level_b[j])
               : MODE == kEpipolar ? gt.line_th[j] : 0.0f;
    }
    __syncthreads();
    // Warp w takes the tiles w, w + 8, ... of the chunk in increasing order.
#pragma unroll 2
    for (int jt = warp * kCols; jt < cnt; jt += kWarps * kCols) {
      // The gate of the thread's four pairs: rows g, g + 8 x columns
      // i = jt + 2t + e, e = 0, 1 (the accumulator fragment's positions).
      const int i0 = jt + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(s.u + i0);
      const float2 v = *reinterpret_cast<const float2*>(s.v + i0);
      const float2 c = *reinterpret_cast<const float2*>(s.c + i0);
      const float ub[2] = {u.x, u.y}, vb_[2] = {v.x, v.y}, cb[2] = {c.x, c.y};
      bool ok[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool col_ok = (i0 + e < cnt) & (s.ok[i0 + e] != 0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool pass = row_ok[r] & col_ok;
          if (MODE == kWindow) {
            const float du = __fsub_rn(ga[r][0], ub[e]);
            const float dv = __fsub_rn(ga[r][1], vb_[e]);
            const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
            const int ldiff = __float_as_int(cb[e]) - la[r];
            pass = pass & (d2 <= ga[r][2]) & (ldiff >= gt.lo) &
                   (ldiff <= gt.hi);
          } else if (MODE == kEpipolar) {
            const float num = __fadd_rn(
                __fadd_rn(__fmul_rn(ga[r][0], ub[e]),
                          __fmul_rn(ga[r][1], vb_[e])), ga[r][2]);
            const float d2 = __fmul_rn(__fmul_rn(num, num), ga[r][3]);
            pass = pass & (d2 < cb[e]);
          }
          ok[r][e] = pass;
        }
      }
      // Distances only for a tile with a pair that passed (warp-uniform, as
      // mma.sync needs the whole warp).
      if (!__any_sync(kFull, ok[0][0] | ok[0][1] | ok[1][0] | ok[1][1]))
        continue;
      const uint32_t* wc = s.words[jt + g];
      int acc[4] = {0, 0, 0, 0};
      mma_and_popc(acc, a, wc[t ^ swz], wc[(t + 4) ^ swz]);
      // acc[2r + e] is (row g + 8r, column i0 + e).
      const int2 pb = *reinterpret_cast<const int2*>(s.pop + i0);
      const int pbe[2] = {pb.x, pb.y};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (ok[r][e])
            push(top[r], pa[r] + pbe[e] - 2 * acc[2 * r + e], c0 + i0 + e);
    }
  }

  // Merge the 4 lanes of each row, then the 8 warps in a fixed order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const Top2 o = {__shfl_xor_sync(kFull, top[r].best, off),
                      __shfl_xor_sync(kFull, top[r].second, off),
                      __shfl_xor_sync(kFull, top[r].bj, off)};
      merge(top[r], o);
    }
    if (t == 0) s_part[warp][g + 8 * r] = top[r];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    Top2 res = s_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(res, s_part[w][threadIdx.x]);
    if (row < n) {
      best_out[row] = res.best;
      second_out[row] = res.second;
      bj_out[row] = res.bj;
    }
  }
}

template <int MODE>
int launch(const int* da, const int* db, const bool* va, const bool* vb,
           int n, int m, const Gates& gt, int* best, int* second, int* bj,
           cudaStream_t stream) {
  const size_t smem = cols_bytes(chunk_cap(m));
  // The 48 KB a block gets without opting in covers the static s_part
  // too: 969-1000 columns fit in it alone but not with s_part.
  if (smem + sizeof(Top2) * kWarps * kRows > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kRows - 1) / kRows;
  match_kernel<MODE><<<blocks, kWarps * 32, smem, stream>>>(
      da, db, va, vb, n, m, gt, best, second, bj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hamming_best2(const int* da, const int* db, const bool* va,
                             const bool* vb, int n, int m, int mode,
                             Gates gates, int* best, int* second, int* bj,
                             cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  switch (mode) {
    case kNone:
      return launch<kNone>(da, db, va, vb, n, m, gates, best, second, bj,
                           stream);
    case kWindow:
      return launch<kWindow>(da, db, va, vb, n, m, gates, best, second, bj,
                             stream);
    case kEpipolar:
      return launch<kEpipolar>(da, db, va, vb, n, m, gates, best, second, bj,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
