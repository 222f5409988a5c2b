// Fused evaluate of sparse image alignment for Hopper.
//
// Replaces the Pallas TPU kernel fused_evaluate
// (svo_pro_universal_tpu/ops/pallas_align.py:47-123, wrapper :126-179).
// Per feature: bilinear sample of a P x P patch at one shared fractional
// origin inside its tile, residual cur*(1+alpha)+beta-ref; summed over
// features: H = sum w J^T J (8x8), g = -sum w J^T r, chi2 = sum w r^2,
// n = sum w. Output: 74 floats [H(64, row-major) | g(8) | chi2 | n].
//
// Bound: bytes, and at N=360 far below the launch: about 0.8 MB of patch
// windows, templates and Jacobians, i.e. ~0.25 us at 3.35 TB/s, against
// ~1 MFLOP. Design: one warp per feature (8 per block); lanes sample the
// patch pixels, stage residuals and Jacobian rows in shared memory, then
// each lane sums whole output entries over the pixels in a fixed order.
// Blocks write partials, and a second one-block pass sums them in block
// order. No float atomics: the sums are the same from run to run, so the
// LM keep-best test (c2_new < best_chi2) cannot flip between runs.
// Bilinear taps outside the tile (at an exact-integer origin the second
// tap has weight 0 and lies at row R or column T) are skipped, never read.

#include <cuda_runtime.h>

namespace {

constexpr int kFeatPerBlock = 8;   // one warp each
constexpr int kMaxArea = 64;       // P*P <= 64
constexpr int kOut = 74;           // 64 + 8 + 2

__global__ void fused_evaluate_partials(
    const float* __restrict__ tiles, const float* __restrict__ ty,
    const float* __restrict__ tx, const float* __restrict__ weight,
    const float* __restrict__ ref, const float* __restrict__ jac,
    const float* __restrict__ ab, float* __restrict__ partials, int n, int R,
    int T, int P) {
  __shared__ float s_res[kFeatPerBlock][kMaxArea];
  __shared__ float s_jac[kFeatPerBlock][kMaxArea][8];
  __shared__ float s_out[kFeatPerBlock][kOut];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kFeatPerBlock + warp;
  const int area = P * P;

  if (f < n) {
    const float alpha = ab[0];
    const float beta = ab[1];
    const float wf = weight[f];
    const float y0f = floorf(ty[f]);
    const float x0f = floorf(tx[f]);
    const float fy = ty[f] - y0f;
    const float fx = tx[f] - x0f;
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
    const float* tile = tiles + (long long)f * R * T;
    for (int p = lane; p < area; p += 32) {
      const int i = p / P;
      const int j = p - i * P;
      // vertical taps first, then horizontal (the Pallas kernel's order)
      float col[2];
      for (int dc = 0; dc < 2; ++dc) {
        const int c = x0 + j + dc;
        float v = 0.f;
        if (c >= 0 && c < T) {
          const int r = y0 + i;
          if (r >= 0 && r < R) v += (1.f - fy) * tile[r * T + c];
          if (r + 1 >= 0 && r + 1 < R) v += fy * tile[(r + 1) * T + c];
        }
        col[dc] = v;
      }
      const float cur = (1.f - fx) * col[0] + fx * col[1];
      const long long q = (long long)f * area + p;
      s_res[warp][p] = cur * (1.f + alpha) + beta - ref[q];
      for (int k = 0; k < 8; ++k) s_jac[warp][p][k] = jac[q * 8 + k];
    }
    __syncwarp();
    for (int o = lane; o < kOut; o += 32) {
      float acc = 0.f;
      if (o < 64) {
        const int a = o >> 3;
        const int b = o & 7;
        for (int p = 0; p < area; ++p)
          acc += (s_jac[warp][p][a] * wf) * s_jac[warp][p][b];
      } else if (o < 72) {
        const int a = o - 64;
        for (int p = 0; p < area; ++p)
          acc += (s_jac[warp][p][a] * wf) * s_res[warp][p];
      } else if (o == 72) {
        for (int p = 0; p < area; ++p)
          acc += (s_res[warp][p] * wf) * s_res[warp][p];
      } else {
        acc = wf;
      }
      s_out[warp][o] = acc;
    }
  } else {
    for (int o = lane; o < kOut; o += 32) s_out[warp][o] = 0.f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kOut; o += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < kFeatPerBlock; ++k) acc += s_out[k][o];
    partials[blockIdx.x * kOut + o] = acc;
  }
}

__global__ void fused_evaluate_reduce(const float* __restrict__ partials,
                                      int nblocks, float* __restrict__ out) {
  for (int o = threadIdx.x; o < kOut; o += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < nblocks; ++b) acc += partials[b * kOut + o];
    out[o] = (o >= 64 && o < 72) ? -acc : acc;
  }
}

}  // namespace

// partials: [ceil(n/8), 74] scratch; out: [74].
extern "C" int svo_fused_evaluate(const float* tiles, const float* ty,
                                  const float* tx, const float* weight,
                                  const float* ref, const float* jac,
                                  const float* ab, float* partials,
                                  float* out, int n, int R, int T, int P,
                                  void* stream) {
  if (P * P > kMaxArea) return (int)cudaErrorInvalidValue;
  const int nblocks = (n + kFeatPerBlock - 1) / kFeatPerBlock;
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks > 0) {
    fused_evaluate_partials<<<nblocks, 32 * kFeatPerBlock, 0, s>>>(
        tiles, ty, tx, weight, ref, jac, ab, partials, n, R, T, P);
  }
  fused_evaluate_reduce<<<1, 128, 0, s>>>(partials, nblocks, out);
  return (int)cudaGetLastError();
}
