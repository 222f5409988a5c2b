// SE(3) on unit quaternions [w, x, y, z], in the operation order of
// utils/transform.py, and the small Cholesky solve of ops/tiles.py, for the
// one thread of a block that runs a Gauss-Newton step (align.cu, pose.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

struct V3 {
  float x, y, z;
};
struct Quat {
  float w, x, y, z;
};
struct Pose {
  Quat q;
  V3 t;
};

// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 quat_rotate(Quat q, V3 v) {
  const V3 qv = {q.x, q.y, q.z};
  const V3 uv = cross(qv, v);
  const V3 c = cross(qv, uv);
  return {v.x + 2.f * (q.w * uv.x + c.x), v.y + 2.f * (q.w * uv.y + c.y),
          v.z + 2.f * (q.w * uv.z + c.z)};
}

__device__ __forceinline__ Quat quat_multiply(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Quat quat_normalize(Quat q) {
  const float n =
      clamp_min(sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), 1e-8f);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

__device__ __forceinline__ Pose compose(Pose a, Pose b) {
  const V3 r = quat_rotate(a.q, b.t);
  return {quat_normalize(quat_multiply(a.q, b.q)),
          {r.x + a.t.x, r.y + a.t.y, r.z + a.t.z}};
}

__device__ __forceinline__ Pose inverse(Pose a) {
  const Quat qi = {a.q.w, -a.q.x, -a.q.y, -a.q.z};
  const V3 r = quat_rotate(qi, a.t);
  return {qi, {-r.x, -r.y, -r.z}};
}

__device__ __forceinline__ void skew2(V3 w, float W[9], float W2[9]) {
  W[0] = 0.f;  W[1] = -w.z; W[2] = w.y;
  W[3] = w.z;  W[4] = 0.f;  W[5] = -w.x;
  W[6] = -w.y; W[7] = w.x;  W[8] = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i * 3 + j] = W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j] +
                      W[i * 3 + 2] * W[6 + j];
}

// exp of the twist [v, w]: so3_exp and the left Jacobian V, t = V v
__device__ Pose se3_exp(const float tw[6]) {
  const V3 w = {tw[3], tw[4], tw[5]};
  const float theta2 = w.x * w.x + w.y * w.y + w.z * w.z;
  // so3_exp
  const float th = sqrtf(clamp_min(theta2, 0.f));
  const float half = 0.5f * th;
  const bool small = theta2 < 1e-8f;
  const float k = small ? 0.5f - theta2 / 48.f : sinf(half) / clamp_min(th, 1e-8f);
  const float qw = small ? 1.f - theta2 / 8.f : cosf(half);
  const Quat q = quat_normalize({qw, k * w.x, k * w.y, k * w.z});
  // so3_left_jacobian
  const float thj = sqrtf(clamp_min(theta2, 1e-8f));
  const float a = small ? 0.5f - theta2 / 24.f : (1.f - cosf(thj)) / theta2;
  const float b = small ? 1.f / 6.f - theta2 / 120.f
                        : (thj - sinf(thj)) / (theta2 * thj);
  float W[9], W2[9];
  skew2(w, W, W2);
  float V[9];
  for (int i = 0; i < 9; ++i)
    V[i] = ((i % 4 == 0) ? 1.f : 0.f) + a * W[i] + b * W2[i];
  const float v[3] = {tw[0], tw[1], tw[2]};
  float t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = V[i * 3] * v[0] + V[i * 3 + 1] * v[1] + V[i * 3 + 2] * v[2];
  return {q, {t[0], t[1], t[2]}};
}

// twist [v, w] of a pose (so3_log, then V^-1 t)
__device__ void se3_log(Pose T, float out[6]) {
  const float s = T.q.w < 0.f ? -1.f : 1.f;
  const float qw = fminf(fmaxf(T.q.w * s, -1.f), 1.f);
  const V3 qv = {T.q.x * s, T.q.y * s, T.q.z * s};
  const float sin_half = sqrtf(qv.x * qv.x + qv.y * qv.y + qv.z * qv.z + 1e-24f);
  const float half = atan2f(sin_half, qw);
  const float k = sin_half < 1e-6f ? 2.f + (2.f * half) * (2.f * half) / 12.f
                                   : 2.f * half / clamp_min(sin_half, 1e-8f);
  const V3 w = {k * qv.x, k * qv.y, k * qv.z};
  const float theta2 = w.x * w.x + w.y * w.y + w.z * w.z;
  const float th = sqrtf(clamp_min(theta2, 1e-8f));
  const float hh = 0.5f * th;
  const float cot = theta2 < 1e-8f
                        ? 1.f / 12.f + theta2 / 720.f
                        : (1.f - hh * cosf(hh) / clamp_min(sinf(hh), 1e-8f)) / theta2;
  float W[9], W2[9];
  skew2(w, W, W2);
  const float t[3] = {T.t.x, T.t.y, T.t.z};
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float vinv = ((i == j) ? 1.f : 0.f) - 0.5f * W[i * 3 + j] + cot * W2[i * 3 + j];
      acc += vinv * t[j];
    }
    out[i] = acc;
  }
  out[3] = w.x;
  out[4] = w.y;
  out[5] = w.z;
}

// H x = g (H row-major D x D) by unrolled Cholesky in the order of
// ops/tiles.cholesky_small / cholesky_solve_small
template <int D>
__device__ void solve_cholesky(const float* H, const float* g, float* x) {
  float L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i * D + j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(clamp_min(s, 1e-20f)) : s / L[j][j];
    }
  }
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < D; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

}  // namespace
