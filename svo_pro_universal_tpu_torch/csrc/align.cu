// Sparse image alignment for Hopper: the fused evaluate, and one pyramid
// level of the LM keep-best loop in one launch.
//
// Replaces the Pallas TPU kernel fused_evaluate
// (svo_pro_universal_tpu/ops/pallas_align.py:47-123, wrapper :126-179) and,
// in svo_align_level, the per-level lax.while_loop that drives it
// (svo_pro_universal_tpu/ops/sparse_img_align.py:341-376).
//
// Per feature (evaluate_feature, shared by both entry points): the bilinear
// sample of a P x P patch at one shared fractional origin inside its tile,
// the residual cur*(1+alpha)+beta-ref, and its 74 normal-system terms
// [H(64, row-major) | g(8) | chi2 | n] = [w J^T J | w J^T r | w r^2 | w];
// g is negated once, after the sums. Bilinear taps outside the tile (at an
// exact-integer origin the second tap has weight 0 and lies at row R or
// column T) are skipped, never read.
//
// svo_fused_evaluate: one evaluate over N features. Bound: bytes, and at
// N=360 far below the launch: about 0.8 MB of patch windows, templates and
// Jacobians, i.e. ~0.25 us at 3.35 TB/s, against ~1 MFLOP. One warp per
// feature (8 per block); blocks write partials, and a second one-block pass
// sums them in block order.
//
// svo_align_level: the whole level, as ops/cuda_align.align_level_plain
// computes it — the initial evaluate (its n is the level's n_tracked), then
// up to max_iter times: the damped 8x8 Cholesky solve, the non-finite
// guard, the SE3 state update, the candidate's evaluate (per-camera
// T_cur_ref, projection, visibility, patch sample), the fixed-parameter
// rows, chi2/max(n,1), the se3_log prior, keep-best and the mu update, and
// an exit once |dx[:6]|^2 < min_update_squared. Outputs stay on the device:
// [best q(4) t(3) alpha beta | best chi2 | n_tracked | iterations].
//
// Bound: latency, not bytes. At N=360, 24x24 tiles, P=4, one level reads
// ~1.05 MB once (~0.31 us at 3.35 TB/s) and does ~1 MFLOP per evaluate, but
// its up to 11 evaluates are serial, each ending in a solve on one thread.
// Design: ONE thread block cluster of kCluster=8 CTAs (the portable
// maximum). CTA r owns features [r*per, (r+1)*per); it stages the first
// `staged` of them (tiles, Jacobians, templates: cp.async.bulk copies that
// complete on an mbarrier; positions and tile origins: plain loads) into
// its shared memory once per launch, so every iteration reads only shared
// memory. Each warp walks its CTA's features and keeps 3 running sums per
// lane; the CTA sums its 8 warps in a fixed order. After cluster.sync(),
// warp 0 of CTA 0 reads the 8 CTAs' sums through distributed shared memory
// in CTA order — no float atomics, so the keep-best test c2_new < best_chi2
// cannot flip from run to run — and its lane 0 does the solve, the update,
// the prior and keep-best, and writes the next candidate to CTA 0's shared
// memory, which the other CTAs read after the next cluster.sync().
//
// Larger N: with the 200 KB staging budget per CTA a feature takes
// (R*T + 9*P*P + 3 + 6) * 4 bytes (2,916 at 24x24, P=4), so a CTA stages
// 70 features and the cluster 560. Beyond N = 560 each CTA reads its
// remaining features from device memory (L2-resident at these sizes) in
// every iteration; the result is the same.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "se3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxArea = 64;         // P*P <= 64
constexpr int kOut = 74;             // 64 + 8 + 2
constexpr int kCluster = 8;          // CTAs per cluster
constexpr int kMaxCams = 8;
constexpr int kCamParams = 16;       // fx fy cx cy | d0..d4 | q(wxyz) | t
constexpr int kMeta = 6;             // y0 x0 lh lw cam ok
constexpr int kSmemBudget = 200 * 1024;
constexpr int kEstAlpha = 1, kEstBeta = 2, kPrior = 4;

// ---------------------------------------------------------------------------
// per-feature evaluate (both entry points)
// ---------------------------------------------------------------------------

// Residual of patch pixel p at tile-local origin (ty, tx): vertical taps
// first, then horizontal (the Pallas kernel's order). A non-finite origin
// samples nothing, as the plain version's one-hot weights do.
__device__ __forceinline__ float patch_residual(const float* tile, int R,
                                                int T, int P, float ty,
                                                float tx, int p, float alpha,
                                                float beta, float ref) {
  float cur = 0.f;
  if (isfinite(ty) && isfinite(tx)) {
    const float y0f = floorf(ty);
    const float x0f = floorf(tx);
    const float fy = ty - y0f;
    const float fx = tx - x0f;
    // clamped before the int conversion: any tap outside the tile is 0
    const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)R);
    const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)T);
    const int i = p / P;
    const int j = p - i * P;
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
    cur = (1.f - fx) * col[0] + fx * col[1];
  }
  return cur * (1.f + alpha) + beta - ref;
}

// Normal-system term o of one feature from its residuals res[area] and
// Jacobian rows jac[area][8], weight wf (g not yet negated).
__device__ __forceinline__ float normal_term(int o, const float* jac,
                                             const float* res, float wf,
                                             int area) {
  float acc = 0.f;
  if (o < 64) {
    const int a = o >> 3;
    const int b = o & 7;
    for (int p = 0; p < area; ++p) acc += (jac[p * 8 + a] * wf) * jac[p * 8 + b];
  } else if (o < 72) {
    const int a = o - 64;
    for (int p = 0; p < area; ++p) acc += (jac[p * 8 + a] * wf) * res[p];
  } else if (o == 72) {
    for (int p = 0; p < area; ++p) acc += (res[p] * wf) * res[p];
  } else {
    acc = wf;
  }
  return acc;
}

// One feature by one warp: lanes sample the patch into s_res, then lane l
// adds terms l, l+32, l+64 to acc. jac may lie in shared or device memory.
__device__ __forceinline__ void evaluate_feature(
    const float* tile, const float* jac, const float* ref, float ty,
    float tx, float wf, int R, int T, int P, float alpha, float beta,
    float* s_res, int lane, float acc[3]) {
  const int area = P * P;
  for (int p = lane; p < area; p += 32)
    s_res[p] = patch_residual(tile, R, T, P, ty, tx, p, alpha, beta, ref[p]);
  __syncwarp();
  for (int k = 0; k < 3; ++k) {
    const int o = lane + 32 * k;
    if (o < kOut) acc[k] += normal_term(o, jac, s_res, wf, area);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// svo_fused_evaluate
// ---------------------------------------------------------------------------

__global__ void fused_evaluate_partials(
    const float* __restrict__ tiles, const float* __restrict__ ty,
    const float* __restrict__ tx, const float* __restrict__ weight,
    const float* __restrict__ ref, const float* __restrict__ jac,
    const float* __restrict__ ab, float* __restrict__ partials, int n, int R,
    int T, int P) {
  __shared__ float s_res[kWarps][kMaxArea];
  __shared__ float s_out[kWarps][kOut];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  const int area = P * P;
  float acc[3] = {0.f, 0.f, 0.f};
  if (f < n) {
    evaluate_feature(tiles + (long long)f * R * T,
                     jac + (long long)f * area * 8,
                     ref + (long long)f * area, ty[f], tx[f], weight[f], R,
                     T, P, ab[0], ab[1], s_res[warp], lane, acc);
  }
  for (int k = 0; k < 3; ++k) {
    const int o = lane + 32 * k;
    if (o < kOut) s_out[warp][o] = acc[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kOut; o += blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < kWarps; ++k) sum += s_out[k][o];
    partials[blockIdx.x * kOut + o] = sum;
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

// ---------------------------------------------------------------------------
// camera models, forward only (cameras/projections.py:189-219)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void distort(int model, const float* d, float& x,
                                        float& y) {
  if (model == 1) {            // RADTAN [k1, k2, p1, p2]
    const float x2 = x * x, y2 = y * y, xy = x * y;
    const float r2 = x2 + y2;
    const float radial = 1.f + d[0] * r2 + d[1] * r2 * r2;
    const float xd = x * radial + 2.f * d[2] * xy + d[3] * (r2 + 2.f * x2);
    const float yd = y * radial + 2.f * d[3] * xy + d[2] * (r2 + 2.f * y2);
    x = xd;
    y = yd;
  } else if (model == 2) {     // EQUIDISTANT [k1..k4] on theta
    const float r = sqrtf(x * x + y * y);
    const float th = atanf(r);
    const float t2 = th * th;
    const float thd =
        th * (1.f + t2 * (d[0] + t2 * (d[1] + t2 * (d[2] + t2 * d[3]))));
    const float s = r > 1e-8f ? thd / clamp_min(r, 1e-8f) : 1.f;
    x *= s;
    y *= s;
  } else if (model == 3) {     // ATAN [s]
    const float r = sqrtf(x * x + y * y);
    const float f = r > 1e-8f
                        ? atanf(r * 2.f * tanf(d[0] / 2.f)) / clamp_min(d[0] * r, 1e-8f)
                        : 2.f * tanf(d[0] / 2.f) / clamp_min(d[0], 1e-8f);
    x *= f;
    y *= f;
  }
}

// pixel of a camera-frame point; cp = one camera's kCamParams floats
__device__ __forceinline__ void project(unsigned model, const float* cp,
                                        V3 X, float& u, float& v) {
  const int proj = model & 3;
  float x, y;
  if (proj == 0) {             // PINHOLE
    const float zi = 1.f / (fabsf(X.z) > 1e-8f ? X.z : 1e-8f);
    x = X.x * zi;
    y = X.y * zi;
  } else if (proj == 1) {      // FISHEYE_EQUIDISTANT
    const float r = sqrtf(X.x * X.x + X.y * X.y);
    const float th = atan2f(r, X.z);
    const float s = r > 1e-8f ? th / clamp_min(r, 1e-8f) : 1.f;
    x = X.x * s;
    y = X.y * s;
  } else {                     // OMNI, xi = d4
    const float n = sqrtf(X.x * X.x + X.y * X.y + X.z * X.z);
    const float den = X.z + cp[8] * n;
    const float di = 1.f / (fabsf(den) > 1e-8f ? den : 1e-8f);
    x = X.x * di;
    y = X.y * di;
  }
  distort((model >> 2) & 3, cp + 4, x, y);
  u = cp[0] * x + cp[2];
  v = cp[1] * y + cp[3];
}

// ---------------------------------------------------------------------------
// svo_align_level
// ---------------------------------------------------------------------------

struct LevelArgs {
  const float* tiles;        // [n, R, T]
  const float* jac;          // [n, P*P, 8]
  const float* ref;          // [n, P*P]
  const float* xyz;          // [n, 3] reference points
  const long long* y0;       // [n] tile origins and level extents
  const long long* x0;
  const long long* lh;
  const long long* lw;
  const unsigned char* ok;   // [n] bool
  const int* cam;            // [n] camera index, or null: camera 0
  const float* cams;         // [n_cams, kCamParams]
  const float* state;        // [9] q t alpha beta
  const float* prior;        // [7] q t of T_prior (read with kPrior)
  float* out;                // [12]
  int n, R, T, P, level, n_cams;
  unsigned models;           // 4 bits a camera: projection | distortion << 2
  int max_iter, flags;
  float min_update_squared, lambda_rot, lambda_trans;
  int per_cta, staged;       // features a CTA owns / stages
};

struct Layout {
  size_t tiles, jac, ref, xyz, meta, total;
};

__host__ __device__ inline size_t up16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int staged, int R, int T, int area) {
  Layout L;
  size_t off = 0;
  L.tiles = off;
  off += up16((size_t)staged * R * T * 4);
  L.jac = off;
  off += up16((size_t)staged * area * 8 * 4);
  L.ref = off;
  off += up16((size_t)staged * area * 4);
  L.xyz = off;
  off += up16((size_t)staged * 3 * 4);
  L.meta = off;
  off += up16((size_t)staged * kMeta * 4);
  L.total = off;
  return L;
}

// The LM state of one level, kept in CTA 0's shared memory by its thread 0.
struct Solver {
  float H[64], g[8];
  float st[9], best[9], cand[9];
  float best_chi2, mu, n_tracked;
  int it, done, done_next;
};

__device__ __forceinline__ Pose load_pose(const float* p) {
  return {{p[0], p[1], p[2], p[3]}, {p[4], p[5], p[6]}};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool bulk_ok(const void* dst, const void* src,
                                        size_t bytes) {
  return bytes > 0 && bytes % 16 == 0 && (uintptr_t)src % 16 == 0 &&
         smem_addr(dst) % 16 == 0;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copy one float array slice into shared memory: by cp.async.bulk (thread
// 0, counted in *tx) when sizes and addresses allow, else by all threads.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             size_t count, uint64_t* bar,
                                             bool issue) {
  const size_t bytes = count * 4;
  if (bulk_ok(dst, src, bytes)) {
    if (issue) bulk_copy(dst, src, (uint32_t)bytes, bar);
  } else {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// One CTA's part of an evaluate at the state s_state: T_cur_ref per camera,
// then each warp walks features warp, warp+8, ... of the CTA; s_part gets
// the CTA's 74 sums (warps added in order).
__device__ void cta_evaluate(const LevelArgs& a, const unsigned char* dyn,
                             const Layout& lo, int f0, int cnt, int ns,
                             const float* s_state, float (*s_cams)[kCamParams],
                             float (*s_tcr)[7], float (*s_res)[kMaxArea],
                             float (*s_warp)[kOut], float* s_part) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int area = a.P * a.P;
  if (tid < a.n_cams) {
    // T_cur_ref = T_cam_body * T_icur_iref * T_cam_body^-1
    const Pose cb = load_pose(&s_cams[tid][9]);
    const Pose T = compose(compose(cb, load_pose(s_state)), inverse(cb));
    s_tcr[tid][0] = T.q.w;
    s_tcr[tid][1] = T.q.x;
    s_tcr[tid][2] = T.q.y;
    s_tcr[tid][3] = T.q.z;
    s_tcr[tid][4] = T.t.x;
    s_tcr[tid][5] = T.t.y;
    s_tcr[tid][6] = T.t.z;
  }
  __syncthreads();
  const float alpha = s_state[7];
  const float beta = s_state[8];
  const float scale = 1.f / (float)(1 << a.level);
  const float cp = (a.P - 1) / 2.f;
  const float eps = 1e-6f;
  const float rmax = (float)((double)(a.R - 1) + 1e-6);
  const float tmax = (float)((double)(a.T - 1) + 1e-6);
  const float* sh_tiles = (const float*)(dyn + lo.tiles);
  const float* sh_jac = (const float*)(dyn + lo.jac);
  const float* sh_ref = (const float*)(dyn + lo.ref);
  const float* sh_xyz = (const float*)(dyn + lo.xyz);
  const int* sh_meta = (const int*)(dyn + lo.meta);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int lf = warp; lf < cnt; lf += kWarps) {
    const float *tile, *jac, *ref;
    V3 X;
    int y0, x0, lh, lw, c;
    bool ok;
    if (lf < ns) {
      tile = sh_tiles + (size_t)lf * a.R * a.T;
      jac = sh_jac + (size_t)lf * area * 8;
      ref = sh_ref + (size_t)lf * area;
      X = {sh_xyz[lf * 3], sh_xyz[lf * 3 + 1], sh_xyz[lf * 3 + 2]};
      const int* m = sh_meta + lf * kMeta;
      y0 = m[0];
      x0 = m[1];
      lh = m[2];
      lw = m[3];
      c = m[4];
      ok = m[5] != 0;
    } else {
      const long long f = f0 + lf;
      tile = a.tiles + f * a.R * a.T;
      jac = a.jac + f * area * 8;
      ref = a.ref + f * area;
      X = {a.xyz[f * 3], a.xyz[f * 3 + 1], a.xyz[f * 3 + 2]};
      y0 = (int)a.y0[f];
      x0 = (int)a.x0[f];
      lh = (int)a.lh[f];
      lw = (int)a.lw[f];
      c = a.cam != nullptr ? a.cam[f] : 0;
      ok = a.ok[f] != 0;
    }
    const float* q = s_tcr[c];
    const V3 r = quat_rotate({q[0], q[1], q[2], q[3]}, X);
    const V3 Xc = {r.x + q[4], r.y + q[5], r.z + q[6]};
    float u, v;
    project((a.models >> (4 * c)) & 15u, s_cams[c], Xc, u, v);
    const float ys0 = v * scale - cp;   // patch pixel (0, 0)
    const float xs0 = u * scale - cp;
    const float ty = ys0 - (float)y0;
    const float tx = xs0 - (float)x0;
    const float lhf = (float)(lh - 1) - eps;
    const float lwf = (float)(lw - 1) - eps;
    const float pm = (float)(a.P - 1);
    const bool vis = ty >= 0.f && ty + pm <= rmax && tx >= 0.f &&
                     tx + pm <= tmax && ys0 >= 0.f && ys0 + pm <= lhf &&
                     xs0 >= 0.f && xs0 + pm <= lwf && Xc.z > 0.f;
    evaluate_feature(tile, jac, ref, ty, tx, (vis && ok) ? 1.f : 0.f, a.R,
                     a.T, a.P, alpha, beta, s_res[warp], lane, acc);
  }
  for (int k = 0; k < 3; ++k) {
    const int o = lane + 32 * k;
    if (o < kOut) s_warp[warp][o] = acc[k];
  }
  __syncthreads();
  if (tid < kOut) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w][tid];
    s_part[tid] = sum;
  }
}

// The normal system at state st from the cluster's sums (g negated): the
// fixed-parameter rows, chi2 / max(n, 1) and the prior (sparse_img_align
// evaluate). Returns chi2; H, g in place.
__device__ float finish_system(const LevelArgs& a, const float* sum,
                               const float* st, float H[64], float g[8],
                               float& nm) {
  for (int i = 0; i < 64; ++i) H[i] = sum[i];
  for (int i = 0; i < 8; ++i) g[i] = sum[64 + i];
  float c2 = sum[72];
  nm = sum[73];
  if (!(a.flags & kEstAlpha)) {
    H[6 * 8 + 6] = 1.f;
    g[6] = 0.f;
  }
  if (!(a.flags & kEstBeta)) {
    H[7 * 8 + 7] = 1.f;
    g[7] = 0.f;
  }
  c2 = c2 / clamp_min(nm, 1.f);
  if (a.flags & kPrior) {
    float e[6];
    se3_log(compose(inverse(load_pose(st)), load_pose(a.prior)), e);
    const float d0 = fabsf(H[0]), d1 = fabsf(H[9]), d2 = fabsf(H[18]);
    const float d3 = fabsf(H[27]), d4 = fabsf(H[36]), d5 = fabsf(H[45]);
    const float h_t = clamp_min(fmaxf(fmaxf(d0, d1), d2), 1.f);
    const float h_r = clamp_min(fmaxf(fmaxf(d3, d4), d5), 1.f);
    float pen = 0.f;
    for (int i = 0; i < 6; ++i) {
      const float lam = (i < 3 ? a.lambda_trans : a.lambda_rot) * (i < 3 ? h_t : h_r);
      H[i * 9] += lam;
      g[i] -= lam * e[i];
      pen += lam * e[i] * e[i];
    }
    c2 = c2 + pen;
  }
  return c2;
}

__device__ void cluster_sum(cg::cluster_group& cluster, float* s_part,
                            float* s_sum, int lane) {
  for (int o = lane; o < kOut; o += 32) {
    float acc = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      acc += cluster.map_shared_rank(&s_part[0], r)[o];
    s_sum[o] = (o >= 64 && o < 72) ? -acc : acc;
  }
}

// candidate = st * exp(-dx[:6]), alpha/beta rule (_state_update)
__device__ void state_update(const float* st, const float dx[8], float* cand) {
  float tw[6];
  for (int i = 0; i < 6; ++i) tw[i] = -dx[i];
  const Pose T = compose(load_pose(st), se3_exp(tw));
  const Quat q = quat_normalize(T.q);
  cand[0] = q.w;
  cand[1] = q.x;
  cand[2] = q.y;
  cand[3] = q.z;
  cand[4] = T.t.x;
  cand[5] = T.t.y;
  cand[6] = T.t.z;
  const float denom = 1.f + dx[6];
  cand[7] = (st[7] - dx[6]) / denom;
  cand[8] = (st[8] - dx[7]) / denom;
}

__global__ void __launch_bounds__(kThreads, 1)
    align_level_kernel(const LevelArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int area = a.P * a.P;

  extern __shared__ __align__(128) unsigned char s_dyn[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ float s_cams[kMaxCams][kCamParams];
  __shared__ float s_tcr[kMaxCams][7];
  __shared__ float s_res[kWarps][kMaxArea];
  __shared__ float s_warp[kWarps][kOut];
  __shared__ float s_part[kOut];    // this CTA's sums, read by CTA 0
  __shared__ float s_sum[kOut];     // CTA 0: the cluster's sums
  __shared__ float s_state[9];      // the state this CTA evaluates
  __shared__ float s_next[10];      // CTA 0: candidate + go flag
  __shared__ Solver s_sol;          // CTA 0, thread 0

  const Layout lo = layout(a.staged, a.R, a.T, area);
  const int f0 = (int)rank * a.per_cta;
  const int cnt = max(0, min(a.per_cta, a.n - f0));
  const int ns = min(cnt, a.staged);

  // ---- stage this CTA's features once ----
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(&s_bar)),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float* sh_tiles = (float*)(s_dyn + lo.tiles);
  float* sh_jac = (float*)(s_dyn + lo.jac);
  float* sh_ref = (float*)(s_dyn + lo.ref);
  float* sh_xyz = (float*)(s_dyn + lo.xyz);
  int* sh_meta = (int*)(s_dyn + lo.meta);
  const size_t nt = (size_t)ns * a.R * a.T;
  const size_t nj = (size_t)ns * area * 8;
  const size_t nr = (size_t)ns * area;
  const float* g_tiles = a.tiles + (size_t)f0 * a.R * a.T;
  const float* g_jac = a.jac + (size_t)f0 * area * 8;
  const float* g_ref = a.ref + (size_t)f0 * area;
  if (tid == 0) {
    uint32_t tx = 0;
    if (bulk_ok(sh_tiles, g_tiles, nt * 4)) tx += (uint32_t)(nt * 4);
    if (bulk_ok(sh_jac, g_jac, nj * 4)) tx += (uint32_t)(nj * 4);
    if (bulk_ok(sh_ref, g_ref, nr * 4)) tx += (uint32_t)(nr * 4);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(&s_bar)),
                 "r"(tx)
                 : "memory");
  }
  stage_floats(sh_tiles, g_tiles, nt, &s_bar, tid == 0);
  stage_floats(sh_jac, g_jac, nj, &s_bar, tid == 0);
  stage_floats(sh_ref, g_ref, nr, &s_bar, tid == 0);
  for (int i = tid; i < ns * 3; i += kThreads) sh_xyz[i] = a.xyz[(size_t)f0 * 3 + i];
  for (int i = tid; i < ns; i += kThreads) {
    const int f = f0 + i;
    int* m = sh_meta + i * kMeta;
    m[0] = (int)a.y0[f];
    m[1] = (int)a.x0[f];
    m[2] = (int)a.lh[f];
    m[3] = (int)a.lw[f];
    m[4] = a.cam != nullptr ? a.cam[f] : 0;
    m[5] = a.ok[f] != 0;
  }
  for (int i = tid; i < a.n_cams * kCamParams; i += kThreads)
    s_cams[i / kCamParams][i % kCamParams] = a.cams[i];
  if (tid < 9) s_state[tid] = a.state[tid];
  mbar_wait(&s_bar, 0);
  __syncthreads();

  // ---- the initial evaluate ----
  cta_evaluate(a, s_dyn, lo, f0, cnt, ns, s_state, s_cams, s_tcr, s_res,
               s_warp, s_part);
  cluster.sync();
  if (rank == 0 && warp == 0) {
    cluster_sum(cluster, s_part, s_sum, lane);
    __syncwarp();
    if (lane == 0) {
      Solver& S = s_sol;
      float nm;
      const float c2 = finish_system(a, s_sum, s_state, S.H, S.g, nm);
      for (int i = 0; i < 9; ++i) S.st[i] = S.best[i] = s_state[i];
      S.best_chi2 = c2;
      S.n_tracked = nm;
      S.mu = 0.1f;
      S.it = 0;
      S.done = 0;
    }
  }

  // ---- LM keep-best iterations ----
  while (true) {
    if (rank == 0 && tid == 0) {
      Solver& S = s_sol;
      const bool go = S.it < a.max_iter && !S.done;
      if (go) {
        float Hd[64], dx[8];
        for (int i = 0; i < 64; ++i) Hd[i] = S.H[i];
        for (int i = 0; i < 8; ++i) Hd[i * 9] = S.H[i * 9] + (S.mu * S.H[i * 9] + 1e-8f);
        solve_cholesky<8>(Hd, S.g, dx);
        float upd = 0.f;
        for (int i = 0; i < 8; ++i) {
          if (!isfinite(dx[i])) dx[i] = 0.f;
          if (i < 6) upd += dx[i] * dx[i];
        }
        state_update(S.st, dx, S.cand);
        S.done_next = upd < a.min_update_squared;
        for (int i = 0; i < 9; ++i) s_next[i] = S.cand[i];
      }
      s_next[9] = go ? 1.f : 0.f;
    }
    cluster.sync();
    const float* next = cluster.map_shared_rank(&s_next[0], 0);
    const bool go = next[9] != 0.f;
    if (tid < 9) s_state[tid] = next[tid];
    __syncthreads();
    if (!go) break;
    cta_evaluate(a, s_dyn, lo, f0, cnt, ns, s_state, s_cams, s_tcr, s_res,
                 s_warp, s_part);
    cluster.sync();
    if (rank == 0 && warp == 0) {
      cluster_sum(cluster, s_part, s_sum, lane);
      __syncwarp();
      if (lane == 0) {
        Solver& S = s_sol;
        float Hn[64], gn[8], nm;
        const float c2 = finish_system(a, s_sum, S.cand, Hn, gn, nm);
        if (c2 < S.best_chi2) {
          for (int i = 0; i < 9; ++i) S.best[i] = S.st[i] = S.cand[i];
          S.best_chi2 = c2;
          S.mu = S.mu * 0.5f;
          for (int i = 0; i < 64; ++i) S.H[i] = Hn[i];
          for (int i = 0; i < 8; ++i) S.g[i] = gn[i];
        } else {
          S.mu = S.mu * 4.f;
        }
        S.it += 1;
        S.done = S.done_next;
      }
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    const Solver& S = s_sol;
    for (int i = 0; i < 9; ++i) a.out[i] = S.best[i];
    a.out[9] = S.best_chi2;
    a.out[10] = S.n_tracked;
    a.out[11] = (float)S.it;
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
  const int nblocks = (n + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks > 0) {
    fused_evaluate_partials<<<nblocks, kThreads, 0, s>>>(
        tiles, ty, tx, weight, ref, jac, ab, partials, n, R, T, P);
  }
  fused_evaluate_reduce<<<1, 128, 0, s>>>(partials, nblocks, out);
  return (int)cudaGetLastError();
}

// One pyramid level of sparse alignment, one cluster launch. out: [12] =
// best q(4) t(3) alpha beta | best chi2 | n_tracked | iterations.
extern "C" int svo_align_level(
    const float* tiles, const float* jac, const float* ref, const float* xyz,
    const long long* y0, const long long* x0, const long long* lh,
    const long long* lw, const unsigned char* ok, const int* cam,
    const float* cams, const float* state, const float* prior, float* out,
    int n, int R, int T, int P, int level, int n_cams, unsigned models,
    int max_iter, int flags, float min_update_squared, float lambda_rot,
    float lambda_trans, void* stream) {
  const int area = P * P;
  if (area > kMaxArea || n_cams < 1 || n_cams > kMaxCams || R < 2 || T < 2 ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  LevelArgs a = {tiles, jac, ref, xyz, y0, x0, lh, lw, ok, cam, cams, state,
                 prior, out, n, R, T, P, level, n_cams, models, max_iter,
                 flags, min_update_squared, lambda_rot, lambda_trans, 0, 0};
  a.per_cta = (n + kCluster - 1) / kCluster;
  const size_t per_feature = (size_t)(R * T + 9 * area + 3 + kMeta) * 4;
  int staged = (int)(kSmemBudget / per_feature);
  if (staged > a.per_cta) staged = a.per_cta;
  while (staged > 0 && layout(staged, R, T, area).total > (size_t)kSmemBudget)
    --staged;
  a.staged = staged;
  const size_t smem = layout(staged, R, T, area).total;
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, align_level_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
