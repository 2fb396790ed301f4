// P1: the PNG unfilter, with the conversion to one float sample a pixel.
//
// Replaces no TPU kernel. It replaces host OpenCV (cv2.imread's libpng
// unfilter and rgb_to_gray, orbslam3_byzyh_tpu/io/euroc.py:31-32,
// kitti.py:27-29, tum_rgbd.py:42-44, and the native prefetcher's
// opencv_imgcodecs), which the card's machine does not have: the host
// inflates a file (zlib, io/png.py) and this kernel undoes the row filters
// on the card, so the image is written where the system reads it.
//
// Input: the inflated scanlines, height rows of (1 + rowbytes) bytes, the
// first byte of each row its filter type (0 None, 1 Sub, 2 Up, 3 Average,
// 4 Paeth). Output: (height, width) float32, the grey byte (mode 0), the
// big-endian 16-bit sample (1), libpng's (9797 R + 19234 G + 3737 B) >> 15
// of RGB (2) or RGBA (3), the grey byte of grey + alpha (4).
//
// What bounds it on this card: the dependency chain, not bytes. Average
// and Paeth need the reconstructed byte to the left (bpp bytes back) and
// the ones above, so each row is sequential and each row waits on the row
// above. Its bytes bound (filtered bytes in, 4 B a pixel out, 1.8 MB at
// 752x480 grey) is about 0.5 us at 3.35 TB/s; the chain is rowbytes +
// height - 1 dependent steps.
//
// Design: one block, one thread a row, in a skewed wavefront. At step s the
// thread of row r reconstructs byte x = s - r, so the byte above (step
// s - 1) and the bytes to the left (s - bpp) are done, and one
// __syncthreads a step makes them visible: rowbytes + rows - 1 barriers,
// 1,231 at 752x480 grey. The dependencies go through shared memory: each
// thread keeps its last bpp + 2 bytes in a ring (ring[s % kRing][t]), so
// the byte above is ring[(s - 1) % kRing][t - 1], the one above-left
// ring[(s - 1 - bpp) % kRing][t - 1] and the one to the left
// ring[(s - bpp) % kRing][t]; the reconstructed bytes also go to a scratch
// buffer in device memory, which only the first row of a chunk reads (the
// last row of the chunk before) and the conversion reads at the end. (A
// first version read every dependency back from that buffer: each step
// then waited on L2, about 5 ms at 752x480 on the H100.) Above 1,024 rows
// the rows are taken in chunks of the block's size, one wavefront after
// the other. Then every thread converts pixels to float32 samples in a
// strided loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

constexpr int kMaxThreads = 1024;
constexpr int kRing = 6;         // bpp + 2 for bpp up to 4

__global__ void unfilter_kernel(const uint8_t* __restrict__ raw, int height,
                                int width, int bpp, int mode,
                                uint8_t* __restrict__ recon,
                                float* __restrict__ out) {
  __shared__ uint8_t ring[kRing][kMaxThreads];
  const int rowbytes = width * bpp;
  const int stride = rowbytes + 1;
  const int t = threadIdx.x;
  for (int r0 = 0; r0 < height; r0 += blockDim.x) {
    const int rows = min((int)blockDim.x, height - r0);
    const int r = r0 + t;
    const bool active = t < rows;
    const int ft = active ? raw[(size_t)r * stride] : 0;
    const uint8_t* in = raw + (size_t)r * stride + 1;
    uint8_t* cur = recon + (size_t)r * rowbytes;
    // The first row of a later chunk reads the row above from the buffer
    // (the chunk before is done); the others from the ring.
    const uint8_t* up = recon + (size_t)(r - 1) * rowbytes;
    const bool up_global = t == 0 && r0 > 0;
    const int steps = rowbytes + rows - 1;
    for (int s = 0; s < steps; ++s) {
      const int x = s - t;
      if (active && x >= 0 && x < rowbytes) {
        const int f = in[x];
        const int a = x >= bpp ? ring[(s - bpp) % kRing][t] : 0;
        int b = 0, c = 0;
        if (up_global) {
          b = up[x];
          c = x >= bpp ? up[x - bpp] : 0;
        } else if (r > 0) {
          b = ring[(s - 1) % kRing][t - 1];
          c = x >= bpp ? ring[(s - 1 - bpp) % kRing][t - 1] : 0;
        }
        int v;
        switch (ft) {
          case 0: v = f; break;
          case 1: v = f + a; break;
          case 2: v = f + b; break;
          case 3: v = f + ((a + b) >> 1); break;
          default: v = f + paeth(a, b, c); break;
        }
        const uint8_t byte = (uint8_t)(v & 0xff);
        ring[s % kRing][t] = byte;
        cur[x] = byte;
      }
      __syncthreads();
    }
  }
  const int n = height * width;
  for (int i = t; i < n; i += blockDim.x) {
    const uint8_t* p = recon + (size_t)i * bpp;
    float v;
    if (mode == 1) {
      v = (float)(((int)p[0] << 8) | (int)p[1]);
    } else if (mode == 2 || mode == 3) {
      v = (float)((9797u * p[0] + 19234u * p[1] + 3737u * p[2]) >> 15);
    } else {
      v = (float)p[0];
    }
    out[i] = v;
  }
}

}  // namespace

// raw: height x (1 + width * bpp) bytes; recon: height x width * bpp bytes
// of scratch; out: height x width float32.
extern "C" int png_unfilter(const uint8_t* raw, int height, int width,
                            int bpp, int mode, uint8_t* recon, float* out,
                            cudaStream_t stream) {
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  if (bpp < 1 || bpp + 2 > kRing) return (int)cudaErrorInvalidValue;
  int threads = height < kMaxThreads ? height : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  unfilter_kernel<<<1, threads, 0, stream>>>(raw, height, width, bpp, mode,
                                             recon, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
