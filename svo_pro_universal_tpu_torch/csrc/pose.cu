// Motion-only pose refinement for Hopper: the whole robust Gauss-Newton
// keep-best loop of ops/pose_optimizer.optimize_pose_plain in one launch.
//
// Replaces no Pallas kernel. The JAX package runs this loop as one
// lax.while_loop (svo_pro_universal_tpu/ops/pose_optimizer.py:98-183) that
// XLA compiles into one program; in eager PyTorch the same loop is ~6,000
// small kernels a call (two evaluates of ~40 ops a round, an unrolled 6x6
// Cholesky of ~180, the update and the keep-best selects, three sorts for
// the medians).
//
// What one launch computes, in float32 with the plain version's formulas:
//   1. each feature's unit-plane residual at T_body_world_init, the behind
//      test, err0 = |e| / 2^level (edgelets: |grad . e|) and valid0 = valid
//      and not behind; sigma = max(1.48 * lower_median(|err0| over valid0),
//      1e-7) and error_before_px = lower_median(err0 * focal over valid0);
//   2. chi2 at the initial pose, the first best;
//   3. up to max_iter rounds: the solve of (H + 1e-8 I) dx = g from the
//      Tukey-weighted, sigma-whitened normal system at the current pose
//      (edgelets projected on grad, their sigma times edgelet_sigma_factor),
//      non-finite entries of dx zeroed, T_new = normalize(exp(dx) * T), the
//      normal system and chi2 at T_new, keep-best. The plain loop freezes
//      its state once |dx|^2 < min_update_squared, and a round whose
//      candidate is not kept leaves its state unchanged, so the next round
//      would repeat it; either ends the loop here with the same result;
//   4. at the best pose: err_px = err / 2^level * focal, inlier = valid0 and
//      err_px <= reproj_thresh_px, their count, and error_after_px =
//      lower_median(err_px over valid0).
// The lower median is robust.masked_median's rule: entries outside the mask
// become FLT_MAX, and the sorted array's entry (count - 1) // 2 (0 when the
// mask is empty, so FLT_MAX) is taken. Here a bitonic sort in shared memory
// over N padded to a power of two sorts order-preserving integer keys
// (NaN after every number, as torch.sort puts it; padding after NaN); the
// value at an index does not depend on how the sort got there.
//
// Bound: latency, not bytes or operations. At N = 360 a call reads ~15 KB
// (xyz, f, grad, level, two masks; ~5 ns at 3.35 TB/s) and does at most 11
// evaluates of ~300 flops a feature (~1.2 MFLOP, ~0.02 us at 67 TFLOP/s);
// what remains is the chain of rounds, each a block reduction and a 6x6
// solve on one thread.
// Design: ONE thread block of kThreads threads; feature i is thread
// (i mod kThreads)'s, so at N <= kThreads each thread evaluates one feature.
// No cross-block reduction and no atomics: each thread sums its features in
// index order, each warp by shuffles in a fixed order, then thread k adds
// the warps' partials of sum k in warp order. The same inputs give the same
// bits on every launch, so the keep-best test cannot flip between runs.
// Thread 0 runs the solve, the update and the keep-best state in registers
// and hands the next pose to the block through shared memory.
//
// N <= kMaxN = 4096. The port's callers pass one frame's feature slots:
// capacity.max_fts, 256 by default (config.py) and 360 in every shipped
// setting (examples/param/pinhole.yaml, bench.vio_config, the benchmark's
// configuration), and loop verification (backend/loop_closing.verify_pose)
// passes one keyframe's slots, the same count. The wrapper raises above
// kMaxN; the shared memory it takes (9 bytes a feature) stays under the
// 48 KB a block has without opting in.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "se3.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 4096;
constexpr int kSums = 28;                     // H upper (21) | J^T w e (6) | chi2
constexpr int kChi2 = 27;
constexpr float kTukeyB = 4.6851f;            // utils/robust.TUKEY_B
constexpr float kTukeyRho = (float)(4.6851 * 4.6851 / 6.0);
constexpr uint32_t kNanKey = 0xFFFFFFFEu;     // after every number
constexpr uint32_t kPadKey = 0xFFFFFFFFu;     // after NaN

struct Args {
  const float* xyz;                // [n, 3] world points
  const float* f;                  // [n, 3] measured bearings
  const float* grad;               // [n, 2] edgelet directions
  const long long* level;          // [n]
  const unsigned char* edgelet;    // [n] bool
  const unsigned char* valid;      // [n] bool
  const float* cb_q;               // T_cam_body q (wxyz) and t
  const float* cb_t;
  const float* init_q;             // T_body_world_init
  const float* init_t;
  const float* intrinsics;         // fx, fy, ...
  float* out;                      // [9] best q t | error before, after
  unsigned char* inlier;           // [n] bool
  long long* n_inliers;            // [1]
  int n;
  int max_iter;
  float reproj_thresh_px;
  float edgelet_sigma_factor;
  float min_update_squared;
};

__device__ __forceinline__ Pose load_pose(const float* q, const float* t) {
  return {{q[0], q[1], q[2], q[3]}, {t[0], t[1], t[2]}};
}

__device__ __forceinline__ void store_pose(float* p, const Pose& T) {
  p[0] = T.q.w; p[1] = T.q.x; p[2] = T.q.y; p[3] = T.q.z;
  p[4] = T.t.x; p[5] = T.t.y; p[6] = T.t.z;
}

// utils/transform.quat_to_matrix, row-major
__device__ __forceinline__ void quat_to_matrix(Quat q, float R[9]) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// utils/robust.tukey_weight / tukey_rho
__device__ __forceinline__ float tukey_weight(float x) {
  const float r = x / kTukeyB;
  const float u = 1.f - r * r;
  return fabsf(r) < 1.f ? u * u : 0.f;
}

__device__ __forceinline__ float tukey_rho(float x) {
  const float r = x / kTukeyB;
  const float r2 = r * r;
  const float u = 1.f - r2;
  return kTukeyRho * (r2 < 1.f ? 1.f - u * u * u : 1.f);
}

// 2^level as pose_optimizer's (1 << level).to(float32)
__device__ __forceinline__ float level_scale(long long lv) {
  return (unsigned long long)lv < 64ull ? (float)(1ll << lv) : 0.f;
}

// Unit-plane residual of feature i at body pose T (pose_optimizer._residuals)
struct Residual {
  float e0, e1;     // uv_meas - uv_est
  V3 p;             // the point in the body frame
  float zi, u, v;   // 1 / z and uv_est
  bool behind;
};

__device__ __forceinline__ Residual residual(const Args& a, int i, Pose T,
                                             Pose cb) {
  const V3 X = {a.xyz[3 * i], a.xyz[3 * i + 1], a.xyz[3 * i + 2]};
  const V3 r = quat_rotate(T.q, X);
  const V3 p = {r.x + T.t.x, r.y + T.t.y, r.z + T.t.z};
  const V3 rc = quat_rotate(cb.q, p);
  const V3 c = {rc.x + cb.t.x, rc.y + cb.t.y, rc.z + cb.t.z};
  const float zi = 1.f / (fabsf(c.z) > 1e-8f ? c.z : 1e-8f);
  const float u = c.x * zi;
  const float v = c.y * zi;
  const float fz = a.f[3 * i + 2];
  const float d = fabsf(fz) > 1e-8f ? fz : 1e-8f;
  return {a.f[3 * i] / d - u, a.f[3 * i + 1] / d - v, p, zi, u, v,
          c.z < 1e-6f};
}

// pose_optimizer._error_norm: |grad . e| for an edgelet, else |e|
__device__ __forceinline__ float error_norm(const Args& a, int i,
                                            const Residual& r) {
  if (a.edgelet[i])
    return fabsf(a.grad[2 * i] * r.e0 + a.grad[2 * i + 1] * r.e1);
  return sqrtf(r.e0 * r.e0 + r.e1 * r.e1);
}

// One feature's whitened, Tukey-weighted terms of the normal system at T
// (optimize_pose_plain's evaluate), added to acc.
__device__ __forceinline__ void accumulate(const Args& a, int i, Pose T,
                                           Pose cb, const float Rcb[9],
                                           float sigma, float acc[kSums]) {
  const Residual r = residual(a, i, T, cb);
  // J = -zi * J_up R [I | -skew(p)]
  float RG[3][6];
  for (int row = 0; row < 3; ++row) {
    const float* Rr = &Rcb[3 * row];
    RG[row][0] = Rr[0];
    RG[row][1] = Rr[1];
    RG[row][2] = Rr[2];
    RG[row][3] = Rr[1] * -r.p.z + Rr[2] * r.p.y;
    RG[row][4] = Rr[0] * r.p.z + Rr[2] * -r.p.x;
    RG[row][5] = Rr[0] * -r.p.y + Rr[1] * r.p.x;
  }
  float J0[6], J1[6];
  for (int k = 0; k < 6; ++k) {
    J0[k] = -r.zi * (RG[0][k] - r.u * RG[2][k]);
    J1[k] = -r.zi * (RG[1][k] - r.v * RG[2][k]);
  }
  const bool edge = a.edgelet[i];
  const float ms = sigma * level_scale(a.level[i]) *
                   (edge ? a.edgelet_sigma_factor : 1.f);
  const float R = 1.f / ms;
  float e0 = r.e0, e1 = r.e1;
  if (edge) {
    const float g0 = a.grad[2 * i], g1 = a.grad[2 * i + 1];
    e0 = g0 * r.e0 + g1 * r.e1;
    e1 = 0.f;
    for (int k = 0; k < 6; ++k) {
      J0[k] = g0 * J0[k] + g1 * J1[k];
      J1[k] = 0.f;
    }
  }
  const float ew0 = e0 * R, ew1 = e1 * R;
  float Jw0[6], Jw1[6];
  for (int k = 0; k < 6; ++k) {
    Jw0[k] = J0[k] * R;
    Jw1[k] = J1[k] * R;
  }
  const float ew_norm = sqrtf(ew0 * ew0 + ew1 * ew1);
  const bool ok = a.valid[i] && !r.behind;
  // a masked feature adds w = 0 times its terms, as the plain sums do
  const float w = ok ? tukey_weight(ew_norm) : 0.f;
  int o = 0;
  for (int j = 0; j < 6; ++j)
    for (int k = j; k < 6; ++k) acc[o++] += (Jw0[j] * Jw0[k] + Jw1[j] * Jw1[k]) * w;
  for (int j = 0; j < 6; ++j) acc[21 + j] += (Jw0[j] * ew0 + Jw1[j] * ew1) * w;
  acc[kChi2] += ok ? tukey_rho(ew_norm) : 0.f;
}

// Block sums of acc in a fixed order, into s_sum (read after the return).
__device__ void block_sum(float acc[kSums], float (*s_part)[kSums],
                          float* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_part[w][threadIdx.x];
    s_sum[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ int block_count(int c, int* s_part) {
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += s_part[w];
  __syncthreads();
  return total;
}

// Order-preserving key of a float: ascending keys are torch.sort's order,
// NaN last.
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return kNanKey;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k >= kNanKey) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The lower median of the first n keys (count of them unmasked), padded
// with kPadKey to npad: robust.masked_median's rule. Sorts key in place.
__device__ float lower_median(uint32_t* key, int n, int npad, int count) {
  __syncthreads();
  for (int k = 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < npad; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const uint32_t x = key[i], y = key[l];
          if ((x > y) == ((i & k) == 0)) {
            key[i] = y;
            key[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  const int idx = count > 0 ? min((count - 1) / 2, n - 1) : 0;
  const float m = key_value(key[idx]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads, 1) pose_gn_kernel(const Args a) {
  __shared__ uint32_t s_key[kMaxN];
  __shared__ float s_err[kMaxN];
  __shared__ unsigned char s_valid0[kMaxN];
  __shared__ float s_part[kWarps][kSums];
  __shared__ float s_sum[kSums];
  __shared__ int s_ipart[kWarps];
  __shared__ float s_T[7];       // the pose the next evaluate reads
  __shared__ float s_best[7];
  __shared__ int s_go;
  const int tid = threadIdx.x;
  const int n = a.n;
  int npad = 1;
  while (npad < n) npad <<= 1;
  const Pose cb = load_pose(a.cb_q, a.cb_t);
  const Pose T0 = load_pose(a.init_q, a.init_t);
  const float focal = 0.5f * (fabsf(a.intrinsics[0]) + fabsf(a.intrinsics[1]));
  float Rcb[9];
  quat_to_matrix(cb.q, Rcb);

  // ---- 1. residuals, the MAD scale and the error before, at T0 ----
  int c = 0;
  for (int i = tid; i < npad; i += kThreads) {
    uint32_t key = kPadKey;
    if (i < n) {
      const Residual r = residual(a, i, T0, cb);
      const float err0 = error_norm(a, i, r) / level_scale(a.level[i]);
      const bool v0 = a.valid[i] && !r.behind;
      s_err[i] = err0;
      s_valid0[i] = v0;
      c += v0;
      key = order_key(v0 ? fabsf(err0) : FLT_MAX);
    }
    s_key[i] = key;
  }
  const int n_valid0 = block_count(c, s_ipart);
  const float sigma =
      clamp_min(1.48f * lower_median(s_key, n, npad, n_valid0), 1e-7f);
  for (int i = tid; i < npad; i += kThreads)
    s_key[i] = i < n ? order_key(s_valid0[i] ? s_err[i] * focal : FLT_MAX)
                     : kPadKey;
  const float error_before = lower_median(s_key, n, npad, n_valid0);

  // ---- 2, 3. the keep-best loop ----
  if (tid == 0) store_pose(s_T, T0);
  __syncthreads();
  // thread 0's state
  Pose best = T0;
  float best_chi2 = 0.f;
  int it = 0;
  bool small = false;
  while (true) {
    const Pose T = load_pose(&s_T[0], &s_T[4]);
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    for (int i = tid; i < n; i += kThreads)
      accumulate(a, i, T, cb, Rcb, sigma, acc);
    block_sum(acc, s_part, s_sum);
    if (tid == 0) {
      const float chi2 = s_sum[kChi2];
      // the first evaluate sets the best; then a candidate is kept when it
      // lowers chi2, and a round that keeps none, or whose step was small,
      // is the last that changes the state
      const bool take = it == 0 || chi2 < best_chi2;
      if (take) {
        best = T;
        best_chi2 = chi2;
        store_pose(s_best, T);
      }
      const bool go = take && !small && it < a.max_iter;
      if (go) {
        float H[36], g[6], dx[6];
        int o = 0;
        for (int j = 0; j < 6; ++j)
          for (int k = j; k < 6; ++k, ++o) H[j * 6 + k] = H[k * 6 + j] = s_sum[o];
        for (int j = 0; j < 6; ++j) {
          H[j * 7] = H[j * 7] + 1e-8f;
          g[j] = -s_sum[21 + j];
        }
        solve_cholesky<6>(H, g, dx);
        float upd = 0.f;
        for (int j = 0; j < 6; ++j) {
          if (!isfinite(dx[j])) dx[j] = 0.f;
          upd += dx[j] * dx[j];
        }
        small = upd < a.min_update_squared;
        Pose Tn = compose(se3_exp(dx), best);
        Tn.q = quat_normalize(Tn.q);
        store_pose(s_T, Tn);
        ++it;
      }
      s_go = go;
    }
    __syncthreads();
    if (!s_go) break;
  }

  // ---- 4. the outlier pass and the error after, at the best pose ----
  const Pose B = load_pose(&s_best[0], &s_best[4]);
  c = 0;
  for (int i = tid; i < npad; i += kThreads) {
    uint32_t key = kPadKey;
    if (i < n) {
      const Residual r = residual(a, i, B, cb);
      const float err_px =
          error_norm(a, i, r) / level_scale(a.level[i]) * focal;
      const bool v0 = s_valid0[i];
      const bool inl = v0 && err_px <= a.reproj_thresh_px;
      a.inlier[i] = inl;
      c += inl;
      key = order_key(v0 ? err_px : FLT_MAX);
    }
    s_key[i] = key;
  }
  const int n_in = block_count(c, s_ipart);
  const float error_after = lower_median(s_key, n, npad, n_valid0);
  if (tid == 0) {
    for (int k = 0; k < 7; ++k) a.out[k] = s_best[k];
    a.out[7] = error_before;
    a.out[8] = error_after;
    *a.n_inliers = n_in;
  }
}

}  // namespace

// One motion-only pose optimization, one block. out: [9] = best q(4) t(3) |
// error_before_px | error_after_px; inlier: [n] bool; n_inliers: [1] int64.
extern "C" int svo_pose_gn(const float* xyz, const float* f, const float* grad,
                           const long long* level,
                           const unsigned char* edgelet,
                           const unsigned char* valid, const float* cb_q,
                           const float* cb_t, const float* init_q,
                           const float* init_t, const float* intrinsics,
                           float* out, unsigned char* inlier,
                           long long* n_inliers, int n, int max_iter,
                           float reproj_thresh_px, float edgelet_sigma_factor,
                           float min_update_squared, void* stream) {
  if (n < 1 || n > kMaxN || max_iter < 0) return (int)cudaErrorInvalidValue;
  const Args a = {xyz, f, grad, level, edgelet, valid, cb_q, cb_t, init_q,
                  init_t, intrinsics, out, inlier, n_inliers, n, max_iter,
                  reproj_thresh_px, edgelet_sigma_factor, min_update_squared};
  pose_gn_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
