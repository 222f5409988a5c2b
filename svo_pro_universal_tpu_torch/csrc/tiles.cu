// Tile gather for Hopper: cut [N, R, T] float32 tiles out of a padded
// [L, H, W] pyramid, or out of a [K, L, H, W] keyframe ring, at per-feature
// int64 origins (kf, level, y0, x0), the port's index type, so the
// wrapper launches exactly one kernel.
//
// Replaces the Pallas TPU kernels gather_tiles / gather_tiles_ring
// (svo_pro_universal_tpu/ops/pallas_tiles.py:58-93, wrappers :105-152).
// Those DMA (8,128)-aligned superset windows because TPU HBM is tiled; here
// the tiles are EXACT R x T windows at the exact origins of the JAX CPU path
// (ops/tiles.py _tile_origin), so the result is a bit-for-bit copy.
//
// Bound: bytes. Each launch moves N*R*T*4 bytes in and out (0.3-5 MB on the
// mono tracking step), i.e. about 0.2-3 us at 3.35 TB/s, less than the
// launch itself. Design: one block per feature, threads walk the tile in
// row-major order so neighbouring threads read neighbouring columns of one
// row (coalesced 4-byte loads); the origins are clipped by the caller, as
// for the Pallas kernel, and are not re-checked here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void gather_tiles_kernel(const float* __restrict__ src,
                                    const long long* __restrict__ kf,
                                    const long long* __restrict__ lvl,
                                    const long long* __restrict__ y0,
                                    const long long* __restrict__ x0,
                                    float* __restrict__ out,
                                    int L, int H, int W, int R, int T) {
  const int n = blockIdx.x;
  const long long plane = (kf != nullptr ? kf[n] : 0) * L + lvl[n];
  const float* base = src + (plane * H + y0[n]) * (long long)W + x0[n];
  float* dst = out + (long long)n * R * T;
  const int area = R * T;
  for (int i = threadIdx.x; i < area; i += blockDim.x) {
    const int r = i / T;
    const int c = i - r * T;
    dst[i] = base[(long long)r * W + c];
  }
}

int launch(const float* src, const long long* kf, const long long* lvl,
           const long long* y0, const long long* x0, float* out, int n,
           int L, int H, int W, int R, int T, void* stream) {
  if (n > 0) {
    gather_tiles_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        src, kf, lvl, y0, x0, out, L, H, W, R, T);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int svo_gather_tiles(const float* pyr, const long long* lvl,
                                const long long* y0, const long long* x0,
                                float* out, int n, int L, int H, int W, int R,
                                int T, void* stream) {
  return launch(pyr, nullptr, lvl, y0, x0, out, n, L, H, W, R, T, stream);
}

extern "C" int svo_gather_tiles_ring(const float* ring, const long long* kf,
                                     const long long* lvl,
                                     const long long* y0,
                                     const long long* x0, float* out, int n,
                                     int L, int H, int W, int R, int T,
                                     void* stream) {
  return launch(ring, kf, lvl, y0, x0, out, n, L, H, W, R, T, stream);
}
