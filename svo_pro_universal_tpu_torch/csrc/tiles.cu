// Tile gather for Hopper: cut [N, R, T] float32 tiles out of a padded
// [L, H, W] pyramid, or out of a [K, L, H, W] keyframe ring, one launch per
// call.
//
// Replaces the Pallas TPU kernels gather_tiles and gather_tiles_ring
// (svo_pro_universal_tpu/ops/pallas_tiles.py: _kernel_pyr and _kernel_ring,
// wrappers gather_tiles :105 and gather_tiles_ring :131) together with the
// origin arithmetic that surrounds them in ops/tiles.py (_tile_origin and the
// kf clip of extract_tiles_ring). The Pallas kernels DMA (8,128)-aligned
// superset windows because TPU memory is tiled; here the tiles are the EXACT
// R x T windows of the JAX CPU path, so the result is a bit-for-bit copy.
//
// Two modes, one kernel per source (gather_tiles_kernel for a pyramid,
// gather_tiles_ring_kernel for the ring, so a profile tells them apart):
// - centres: each feature reads its (y, x) centre (float32, by stride), its
//   level and its ring slot (int32 or int64) and computes, in the operation
//   order of the plain version (ops/cuda_tiles.py tile_origins),
//   lvl = clamp(level, 0, L-1), lh = H >> lvl, lw = W >> lvl,
//   y0 = clamp(round(cy) - R/2, 0, H-R), the same for x, and
//   kf = clamp(kf, 0, K-1); it writes (y0, x0, lh, lw) as int64 beside the
//   tile. round is rintf (half to even, as torch.round); the float -> int64
//   cast is the saturating cvt that PyTorch's own cast compiles to (NaN -> 0,
//   +-inf and 1e30 -> INT64_MAX / MIN), and "- R/2" wraps as PyTorch's int64
//   subtraction does (done unsigned: signed overflow is undefined in C++).
// - origins given: (kf, level, y0, x0) are read as they are (the TPU
//   kernel's own signature, pre-clipped by the caller).
//
// Bound: bytes. A launch moves N*R*T*4 bytes in and out plus 8-48 bytes of
// indices a feature (0.3-10 MB on the mono tracking step): 0.1-3 us at
// 3.35 TB/s. At these shapes the launch itself (~2 us) costs more than
// that, so the design first makes the whole call one launch (no eager index
// ops around it), then keeps every tile in flight at once:
// - One CTA per tile (64-256 threads, about four floats each), so all N
//   tiles are requested together; the CTA's threads write consecutive
//   floats of the row-major output tile (coalesced stores).
// - TMA route: a 2-D tensor map over the source viewed as [planes*H, W].
//   A TMA box must start on a 16-byte boundary (an unaligned start faults
//   with an illegal instruction) and x0 is arbitrary, so thread 0 loads the
//   box (T+4, R) from x0 rounded down to a multiple of 4 floats with
//   cp.async.bulk.tensor onto an mbarrier, and the CTA copies the tile out
//   of shared memory from column x0 % 4 (columns past W arrive as zeros and
//   are never read). The shift is why the store is the threads' and not a
//   bulk copy's. Needs a 16-byte-aligned base, a row pitch W*4 and a box
//   row (T+4)*4 that are multiples of 16 bytes (T a multiple of 4), and
//   R, T+4 <= 256: true at 752 wide for tiles of 12, 24 and 40.
// - LSU route, every other shape (a 754-wide source, or 10 x 10 tiles,
//   say): the same CTA
//   reads the tile straight from device memory.
// The route is chosen from the shape before the launch (svo_gather_route).
// The launch allocates nothing and does not synchronize (graph-capturable);
// the tensor map is encoded on the host with cuTensorMapEncodeTiled (from
// cudaGetDriverEntryPoint: the library links no -lcuda) and cached by
// (pointer, rows, W, R, T), so a pointer the caching allocator reuses for
// another tensor of the same shape gets the same, still right, map.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kMaxCtas = 65535;      // one CTA a tile up to here
constexpr size_t kSmemBudget = 48 * 1024;  // no opt-in attribute needed
constexpr int kEncodeFailed = 10000;  // + CUresult of the map encoding

struct Args {
  const float* src;
  const void* kf;       // [n] ring slot (ring only)
  const void* lvl;      // [n] pyramid level
  const void* y0;       // [n] origins given (else null)
  const void* x0;       // [n]
  const float* ctr;     // [n, 2] (y, x) centres mode (else null)
  long long cs0, cs1;   // centre strides, elements
  long long* org;       // [4, n] y0, x0, lh, lw (centres mode)
  float* out;           // [n, R, T]
  int n, K, L, H, W, R, T;
  int wide;             // bit i: index array i is int64 (kf, lvl, y0, x0)
};

struct Origin {
  long long row;   // source row in the [planes*H, W] view
  long long x;     // first column
  long long y;     // first row inside the level (centres mode)
  long long lvl;   // clamped level (centres mode)
};

__device__ __forceinline__ long long index_at(const void* p, int wide,
                                              int bit, int i) {
  return ((wide >> bit) & 1) ? static_cast<const long long*>(p)[i]
                             : (long long)static_cast<const int*>(p)[i];
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return min(max(v, lo), hi);
}

// clamp(round(c) - half, 0, hi) in the integer semantics of PyTorch's
// int64 ops on the card (see the note at the top).
__device__ __forceinline__ long long tile_start(float c, int half,
                                                long long hi) {
  const long long r = __float2ll_rz(rintf(c));
  const long long s =
      (long long)((unsigned long long)r - (unsigned long long)half);
  return clamp_ll(s, 0, hi);
}

template <bool kRing>
__device__ __forceinline__ Origin origin(const Args& a, int n) {
  Origin o;
  long long plane;
  if (a.ctr != nullptr) {
    o.lvl = clamp_ll(index_at(a.lvl, a.wide, 1, n), 0, a.L - 1);
    const float* c = a.ctr + n * a.cs0;
    o.y = tile_start(c[0], a.R / 2, a.H - a.R);
    o.x = tile_start(c[a.cs1], a.T / 2, a.W - a.T);
    const long long k =
        kRing ? clamp_ll(index_at(a.kf, a.wide, 0, n), 0, a.K - 1) : 0;
    plane = k * a.L + o.lvl;
  } else {
    o.lvl = index_at(a.lvl, a.wide, 1, n);
    o.y = index_at(a.y0, a.wide, 2, n);
    o.x = index_at(a.x0, a.wide, 3, n);
    plane = (kRing ? index_at(a.kf, a.wide, 0, n) : 0) * a.L + o.lvl;
  }
  o.row = plane * a.H + o.y;
  return o;
}

__device__ __forceinline__ void write_origin(const Args& a, int n,
                                             const Origin& o) {
  a.org[n] = o.y;
  a.org[a.n + n] = o.x;
  a.org[2 * a.n + n] = (long long)a.H >> o.lvl;
  a.org[3 * a.n + n] = (long long)a.W >> o.lvl;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(float* buf, uint64_t* bar,
                                         uint64_t map, const Origin& o,
                                         uint32_t bytes) {
  // the CTA's generic reads of this buffer come before the async write
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(buf)),
      "l"(map), "r"((int)(o.x & ~3LL)), "r"((int)o.row), "r"(smem_u32(bar))
      : "memory");
}

// One CTA per tile (CTA b takes features b, b + gridDim.x, ...); its
// threads write consecutive floats of the row-major output tile, so each
// warp's stores are coalesced. TMA route: thread 0 loads the tile's box
// (T + 4 columns from x0 rounded down to a multiple of 4, rows R) into
// shared memory onto an mbarrier, and the CTA copies it out from column
// x0 % 4; columns past W arrive as zeros and are never read. LSU route: the
// CTA reads the tile straight from device memory.
template <bool kRing, bool kTma>
__device__ __forceinline__ void copy_tiles(const Args& a, uint64_t map) {
  extern __shared__ unsigned char s_dyn[];
  __shared__ __align__(8) uint64_t s_bar;
  const int tid = threadIdx.x;
  const int area = a.R * a.T;
  const int tb = a.T + 4;
  float* buf = reinterpret_cast<float*>(
      s_dyn + ((128u - (smem_u32(s_dyn) & 127u)) & 127u));
  if constexpr (kTma) {
    if (tid == 0) {
      // fetch the descriptor while the origins are loaded
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&s_bar)),
                   "r"(1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int n = blockIdx.x, j = 0; n < a.n; n += gridDim.x, ++j) {
    const Origin o = origin<kRing>(a, n);
    if (tid == 0 && a.ctr != nullptr) write_origin(a, n, o);
    const float* src;
    int pitch;
    if constexpr (kTma) {
      if (tid == 0) tma_load(buf, &s_bar, map, o, (uint32_t)(a.R * tb * 4));
      mbar_wait(&s_bar, (uint32_t)j & 1u);
      src = buf + (o.x & 3);
      pitch = tb;
    } else {
      src = a.src + o.row * a.W + o.x;
      pitch = a.W;
    }
    float* dst = a.out + (size_t)n * area;
    for (int i = tid; i < area; i += blockDim.x) {
      const int r = i / a.T;
      dst[i] = src[(long long)r * pitch + (i - r * a.T)];
    }
    if constexpr (kTma) __syncthreads();  // the buffer is read before reuse
  }
}

// The tensor map is a __grid_constant__ parameter: TMA reads it in place
// through its generic address, taken here in the kernel itself.
template <bool kTma>
__global__ void gather_tiles_kernel(const __grid_constant__ CUtensorMap map,
                                    const Args a) {
  copy_tiles<false, kTma>(a, reinterpret_cast<uint64_t>(&map));
}

template <bool kTma>
__global__ void gather_tiles_ring_kernel(
    const __grid_constant__ CUtensorMap map, const Args a) {
  copy_tiles<true, kTma>(a, reinterpret_cast<uint64_t>(&map));
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

struct MapEntry {
  const void* ptr;
  long long rows;
  int W, R, T;
  CUtensorMap map;
};

constexpr int kMaps = 32;
std::mutex g_maps_mu;
MapEntry g_maps[kMaps];
int g_maps_used = 0;
int g_maps_next = 0;

// The [rows, W] float32 tensor map of src with box (T + 4, R), cached.
int tensor_map(const float* src, long long rows, int W, int R, int T,
               CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_maps_used; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == src && e.rows == rows && e.W == W && e.R == R && e.T == T) {
      *out = e.map;
      return 0;
    }
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box[2] = {(cuuint32_t)(T + 4), (cuuint32_t)R};
  const cuuint32_t elem[2] = {1, 1};
  MapEntry& e = g_maps[g_maps_next];
  const CUresult r =
      enc(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)src, dims,
          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return kEncodeFailed + (int)r;
  }
  e.ptr = src;
  e.rows = rows;
  e.W = W;
  e.R = R;
  e.T = T;
  *out = e.map;
  g_maps_next = (g_maps_next + 1) % kMaps;
  if (g_maps_used < kMaps) ++g_maps_used;
  return 0;
}

// Dynamic shared memory of a TMA-route CTA: one box and alignment slack.
size_t tma_smem(int R, int T) { return 128 + (size_t)R * (T + 4) * 4; }

// Whether the shape takes the TMA route: a 16-byte-aligned source whose row
// pitch is a multiple of 16 bytes, and a box of at most 256 x 256 inside
// the source and the default 48 KB of dynamic shared memory, whose rows of
// (T + 4) floats are a multiple of 16 bytes (cuTensorMapEncodeTiled
// refuses other boxes).
bool tma_route(const float* src, int W, int R, int T) {
  return (uintptr_t)src % 16 == 0 && (W * 4) % 16 == 0 && T % 4 == 0 &&
         R <= 256 && T + 4 <= 256 && T + 4 <= W &&
         tma_smem(R, T) <= kSmemBudget;
}

// Threads a CTA: about four floats of the tile each, whole warps, 64-256.
int cta_threads(int R, int T) {
  const int t = (R * T / 4 + 31) / 32 * 32;
  return std::min(std::max(t, 64), 256);
}

template <bool kRing>
int launch(Args a, void* stream) {
  if (a.n <= 0 || a.R < 1 || a.T < 1 || a.R > a.H || a.T > a.W)
    return a.n == 0 ? 0 : (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = std::min(a.n, kMaxCtas);
  const int threads = cta_threads(a.R, a.T);
  if (tma_route(a.src, a.W, a.R, a.T)) {
    CUtensorMap map;
    const long long rows = (long long)(kRing ? a.K : 1) * a.L * a.H;
    const int rc = tensor_map(a.src, rows, a.W, a.R, a.T, &map);
    if (rc != 0) return rc;
    const size_t smem = tma_smem(a.R, a.T);
    if constexpr (kRing) {
      gather_tiles_ring_kernel<true><<<grid, threads, smem, s>>>(map, a);
    } else {
      gather_tiles_kernel<true><<<grid, threads, smem, s>>>(map, a);
    }
  } else {
    const CUtensorMap map = {};
    if constexpr (kRing) {
      gather_tiles_ring_kernel<false><<<grid, threads, 0, s>>>(map, a);
    } else {
      gather_tiles_kernel<false><<<grid, threads, 0, s>>>(map, a);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when tiles of R x T from a source of width W at src take the TMA route,
// 0 for the plain-load (LSU) route.
extern "C" int svo_gather_route(const float* src, int W, int R, int T) {
  return tma_route(src, W, R, T) ? 1 : 0;
}

// Tiles of a padded [L, H, W] pyramid. centres != null: centres mode
// (origins [4, n] written); else origins given in lvl / y0 / x0.
extern "C" int svo_gather_tiles(const float* pyr, const void* lvl,
                                const void* y0, const void* x0,
                                const float* centres, long long cs0,
                                long long cs1, long long* origins, float* out,
                                int n, int L, int H, int W, int R, int T,
                                int wide, void* stream) {
  const Args a = {pyr, nullptr, lvl, y0, x0, centres, cs0, cs1, origins,
                  out, n, 1, L, H, W, R, T, wide};
  return launch<false>(a, stream);
}

// The same from a [K, L, H, W] keyframe ring with a per-feature slot kf.
extern "C" int svo_gather_tiles_ring(const float* ring, const void* kf,
                                     const void* lvl, const void* y0,
                                     const void* x0, const float* centres,
                                     long long cs0, long long cs1,
                                     long long* origins, float* out, int n,
                                     int K, int L, int H, int W, int R, int T,
                                     int wide, void* stream) {
  const Args a = {ring, kf, lvl, y0, x0, centres, cs0, cs1, origins,
                  out, n, K, L, H, W, R, T, wide};
  return launch<true>(a, stream);
}
