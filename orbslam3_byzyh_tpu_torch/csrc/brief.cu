// K1: steered-BRIEF sampling + compare + bit packing, all pyramid levels.
//
// Replaces orbslam3_byzyh_tpu/ops/pallas_brief.py::brief_sample (the Pallas
// _kernel) and the A<B compare and _pack_bits that follow it in
// fast_orb.extract.
//
// What bounds it on this card: latency of scattered reads. Each keypoint
// reads 512 pixels of its blurred level at data-dependent positions; the
// work is 1024 keypoints x 512 loads, tiny next to the card's bandwidth,
// and the whole blurred pyramid (~1.2 MB at 640x480) stays in L2.
//
// Design: one warp per keypoint. Lane l computes pair 32*w + l of word w:
// it rotates both points, rounds half-to-even (rintf, like torch.round and
// jnp.round), clamps to the level and reads both pixels straight from
// global memory (L2-resident), so the TPU's dual shifted image copies and
// one-hot MXU selection have no counterpart here. __ballot_sync packs the
// 32 comparisons of a word, so the kernel writes (K, 8) int32 words and the
// (K, 512) sample matrix never exists. The pattern is staged in shared
// memory rather than __constant__ memory: the lanes of a warp read 32
// different pairs, which the constant cache would serialise. One launch
// covers every level through a by-value table of level offsets and sizes.
//
// Exactness: the rotation is written with __fmul_rn/__fsub_rn/__fadd_rn so
// nvcc cannot contract it into an FMA, which would move the .5 rounding
// boundaries away from the plain PyTorch version's.

#include <cuda_runtime.h>

constexpr int kMaxLevels = 16;

// Element offset, height and width of each level inside the concatenated
// blurred-pyramid buffer (matches cuda_brief._LevelTable).
struct LevelTable {
  int offset[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSamples = 512;   // 256 A points then 256 B points

__device__ __forceinline__ float sample(const float* __restrict__ im, int h,
                                        int w, float cx, float cy, float px,
                                        float py, float c, float s) {
  const float col = rintf(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
  const float row = rintf(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
  const float gx = fminf(fmaxf(__fadd_rn(cx, col), 0.0f), (float)(w - 1));
  const float gy = fminf(fmaxf(__fadd_rn(cy, row), 0.0f), (float)(h - 1));
  return im[(int)gy * w + (int)gx];
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
brief_kernel(const float* __restrict__ img, LevelTable levels,
             const int* __restrict__ kp_level, const float* __restrict__ xy,
             const float* __restrict__ ca, const float* __restrict__ sa,
             const float* __restrict__ pattern, int k,
             int* __restrict__ out) {
  __shared__ float s_px[kSamples];
  __shared__ float s_py[kSamples];
  for (int i = threadIdx.x; i < kSamples; i += blockDim.x) {
    s_px[i] = pattern[i];
    s_py[i] = pattern[kSamples + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (kp >= k) return;  // the whole warp leaves together

  const int lv = kp_level[kp];
  const float* im = img + levels.offset[lv];
  const int h = levels.h[lv];
  const int w = levels.w[lv];
  const float c = ca[kp];
  const float s = sa[kp];
  const float cx = rintf(xy[2 * kp]);
  const float cy = rintf(xy[2 * kp + 1]);

  int word_out = 0;
#pragma unroll
  for (int word = 0; word < 8; ++word) {
    const int p = word * 32 + lane;
    const float va = sample(im, h, w, cx, cy, s_px[p], s_py[p], c, s);
    const float vb = sample(im, h, w, cx, cy, s_px[256 + p], s_py[256 + p],
                            c, s);
    const unsigned bits = __ballot_sync(0xffffffffu, va < vb);
    if (lane == word) word_out = (int)bits;
  }
  if (lane < 8) out[kp * 8 + lane] = word_out;
}

}  // namespace

extern "C" int brief_descriptors(const float* img, LevelTable levels,
                                 const int* kp_level, const float* xy,
                                 const float* ca, const float* sa,
                                 const float* pattern, int k, int* out,
                                 cudaStream_t stream) {
  const int blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  brief_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      img, levels, kp_level, xy, ca, sa, pattern, k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
