// K1: steered-BRIEF sampling + compare + bit packing, all pyramid levels.
//
// Replaces orbslam3_byzyh_tpu/ops/pallas_brief.py::brief_sample (the Pallas
// _kernel) and the A<B compare and _pack_bits that follow it in
// fast_orb.extract.
//
// What bounds it on this card: latency, not bytes. The work is ~1200
// keypoints x 512 reads at data-dependent positions (~300 K distinct pixels,
// ~1.2 MB); the blurred levels were written just before and lie in L2. The
// time is one launch, the grid, and the chain of dependent loads a thread
// waits on.
//
// Design: one block of 4 warps per keypoint, each thread two point pairs.
// Warp w makes descriptor words w and w + 4: lane l rotates pairs 32 w + l
// and 32 w + l + 128 (both points of each), rounds half to even (rintf,
// like torch.round and jnp.round), clamps to the level and reads the four
// pixels straight from global memory, all four gathers in flight at once.
// __ballot_sync packs the warp's 32 compares into a word and lane 0 writes
// it; the (K, 512) sample matrix never exists. Before any gather a thread
// starts all its other loads at once: the keypoint's level, centre and
// angle (one broadcast load each for the warp) and its pairs' four pattern
// coordinates as one float4 each from a 4 KB read-only table that stays in
// L1, so there is no shared-memory staging and no barrier. The levels are
// not concatenated: a by-value table holds each level's own base pointer,
// height and width. The angle's cosine and sine come from sincosf in the
// kernel, which chip_smoke.py holds bit-equal to torch.cos / torch.sin on
// the card (brief_sincos below exposes it). Of the block shapes tried on an
// H100 (32 to 256 threads a keypoint, 1 to 8 keypoints a block), 128
// threads and one keypoint a block was the fastest at 1200 keypoints.
//
// Exactness: the rotation is written with __fmul_rn/__fsub_rn/__fadd_rn so
// nvcc cannot contract it into an FMA, which would move the .5 rounding
// boundaries away from the plain PyTorch version's; no fast-math flags.

#include <cuda_runtime.h>

constexpr int kMaxLevels = 16;

// Each level's blurred image (row-major, h x w float32), as the caller holds
// it (matches cuda_brief._LevelTable).
struct LevelTable {
  const float* base[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

namespace {

constexpr int kThreads = 128;    // a block: one keypoint
constexpr int kPerThread = 256 / kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sample(const float* __restrict__ im, int h,
                                        int w, float cx, float cy, float px,
                                        float py, float c, float s) {
  const float col = rintf(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
  const float row = rintf(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
  const float gx = fminf(fmaxf(__fadd_rn(cx, col), 0.0f), (float)(w - 1));
  const float gy = fminf(fmaxf(__fadd_rn(cy, row), 0.0f), (float)(h - 1));
  return __ldg(im + (int)gy * w + (int)gx);
}

__global__ void __launch_bounds__(kThreads)
brief_kernel(const LevelTable levels, const int* __restrict__ kp_level,
             const float2* __restrict__ xy, const float* __restrict__ angle,
             const float4* __restrict__ pattern, int* __restrict__ out) {
  const int kp = blockIdx.x;
  const int t = threadIdx.x;       // pairs t + kThreads * j
  const int lv = __ldg(kp_level + kp);
  const float2 c = __ldg(xy + kp);
  const float a = __ldg(angle + kp);
  float4 q[kPerThread];            // ax, ay, bx, by
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    q[j] = __ldg(pattern + t + kThreads * j);
  }

  float s, co;
  sincosf(a, &s, &co);
  const float* im = levels.base[lv];
  const int h = levels.h[lv];
  const int w = levels.w[lv];
  const float cx = rintf(c.x);
  const float cy = rintf(c.y);
  float va[kPerThread], vb[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    va[j] = sample(im, h, w, cx, cy, q[j].x, q[j].y, co, s);
    vb[j] = sample(im, h, w, cx, cy, q[j].z, q[j].w, co, s);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned bits = __ballot_sync(kFull, va[j] < vb[j]);
    if ((t & 31) == 0) {
      out[8 * kp + (t >> 5) + (kThreads / 32) * j] = (int)bits;
    }
  }
}

__global__ void sincos_kernel(const float* __restrict__ angle, int n,
                              float* __restrict__ s, float* __restrict__ c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sincosf(angle[i], s + i, c + i);
}

}  // namespace

extern "C" int brief_descriptors(LevelTable levels, const int* kp_level,
                                 const float* xy, const float* angle,
                                 const float* pattern, int k, int* out,
                                 cudaStream_t stream) {
  if (k <= 0) return (int)cudaSuccess;
  brief_kernel<<<k, kThreads, 0, stream>>>(
      levels, kp_level, reinterpret_cast<const float2*>(xy), angle,
      reinterpret_cast<const float4*>(pattern), out);
  return (int)cudaGetLastError();
}

// The kernel's sincosf on its own, for holding it against torch.cos and
// torch.sin on the card (not on the main path).
extern "C" int brief_sincos(const float* angle, int n, float* s, float* c,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  sincos_kernel<<<(n + 255) / 256, 256, 0, stream>>>(angle, n, s, c);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
