// Epoch-windowed slab cull: one byte per (cluster, 256-ray tile), bit k set
// when a ray of the tile's 32-ray subtile k enters the cluster's box inside
// its current epoch window.
//
// Replaces: raytrace_tpu/ops/epoch_intersect.py `_cull_kernel` (body
// `_cull_kernel_body`, launched by `_cull_bits`), which tests groups of 8
// tiles against 2,048-cluster chunks as dense [256, chunk] blocks, ORs each
// 32-row slice into a bit and writes int32 [n_tiles, C].
//
// Bound on the H100: fp32 instruction issue. Each ray-cluster test is 32
// operations (6 differences, 6 products, 11 min/max, 5 compares, 4 ands) on
// 24 bytes of box that every ray of a tile shares; the output is one byte
// per 256 tests, so memory moves little next to the arithmetic. Most of
// what a launch asks is wasted work: rays of a photon launch that leave the
// scene box, or that an earlier epoch resolved, test every box and set no
// bit. So the design cuts instructions per test and tests per launch:
//
// - Exact early-out. Each ray first runs the same test against the scene
//   box S = [smin, smax], which holds every real cluster (index < n_real).
//   x ↦ (x − o)·inv rounds monotonically, so without NaN each real
//   cluster's slab values lie between S's on every axis: tn ≥ tn_S,
//   tf ≤ tf_S, tnc ≥ tnc_S. A hit needs tn ≤ tf, tf > tmin and
//   w0 ≤ tnc ≤ tf (tnc = max(tn, tmin)), tnc < w1 and tnc < tbest, hence
//   tn_S ≤ tf_S, tf_S > tmin, w0 ≤ tf_S, tnc_S < w1, tnc_S < tbest and
//   w0 < tbest. A NaN among a cluster's slab values makes tn and tf NaN and
//   the cluster misses; a NaN among S's (0·inf where a direction component
//   is denormal or an origin lies on a face plane) means "may hit": with
//   finite boxes and directions such a ray hits no real cluster, but with
//   an unbounded cluster and an infinite direction component it can. A warp
//   none of whose rays may hit sets its bits of every real cluster to 0
//   untested; a block whose warps all skip writes those zeros and tests
//   only the padding clusters (index ≥ n_real, boxes (+inf, −inf), whose
//   slab (−inf, +inf) passes every live ray in epoch 0), as the plain
//   version does. ops/epoch_kernels.py `precull_plain` is the same
//   predicate; tests/test_torch_epoch_precull.py holds it exact.
// - min.NaN.f32 / max.NaN.f32 (sm_80+): torch.minimum's NaN rule in one
//   instruction instead of two compares and a select.
// - Four rays per thread, so each box — two 128-bit broadcast loads from
//   shared memory — serves four tests. Warp w of a block holds rays
//   [128 w, 128 w + 128) of its four tiles: subtiles 4(w % 2) .. +3 of tile
//   w / 2. Each thread ORs its hits into a word per ray over 32 boxes, and
//   one `__reduce_or_sync` per word gives the subtiles' bits; the block
//   writes each cluster's four tile bytes as one 32-bit store.
//
// The mask is cluster-major, uint8 [C, n_tiles]: the order the pair
// compaction reads (JAX transposes its int32 mask for it). Tiles past the
// live prefix (rays sort dead-last) write zeros without testing; the live
// count is read on the device, so the host never waits. Operation order is
// the plain version's and the library is built with --fmad=false, so the
// mask equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256
#define THREADS 256
#define RPT 4                            // rays per thread
#define TILES (THREADS * RPT / TILE)     // tiles per block
#define CHUNK 256                        // boxes staged per pass
#define STEP 8                           // boxes per unrolled step
#define CLUSTERS_PER_BLOCK 1024
#define FULL 0xffffffffu

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, lo, tb, a, b;  // tmin, tbest, w0, w1
};

// entry and exit distances of the ray through box [bmin, bmax]: the plain
// version's operations in its order
__device__ __forceinline__ void slab(const Ray& r, float4 bmin, float4 bmax,
                                     float& tn, float& tf) {
  const float tx0 = (bmin.x - r.ox) * r.ix, tx1 = (bmax.x - r.ox) * r.ix;
  const float ty0 = (bmin.y - r.oy) * r.iy, ty1 = (bmax.y - r.oy) * r.iy;
  const float tz0 = (bmin.z - r.oz) * r.iz, tz1 = (bmax.z - r.oz) * r.iz;
  tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
               nan_min(tz0, tz1));
  tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
               nan_max(tz0, tz1));
}

// the entry distance clamped to the ray start puts each cluster in exactly
// one epoch window [w0, w1); resolved rays cull nothing
__device__ __forceinline__ bool window_hit(const Ray& r, float tn, float tf) {
  const float tnc = nan_max(tn, r.lo);
  return tn <= tf && tf > r.lo && tnc >= r.a && tnc < r.b && tnc < r.tb;
}

// the scene box's necessary conditions (see the note above)
__device__ __forceinline__ bool may_hit(const Ray& r, float tn, float tf) {
  const float tnc = nan_max(tn, r.lo);
  return tn != tn || (tn <= tf && tf > r.lo && r.a <= tf && tnc < r.b &&
                      tnc < r.tb && r.a < r.tb);
}

// the block's bytes of cluster c: byte t for tile tile0 + t
__device__ __forceinline__ void store_bytes(uint8_t* out, int c, int n_tiles,
                                            int tile0, uint32_t bytes) {
  uint8_t* p = out + (size_t)c * n_tiles + tile0;
  if (n_tiles % TILES == 0) {  // aligned: tile0 and the row are multiples of 4
    *reinterpret_cast<uint32_t*>(p) = bytes;
  } else {
    for (int t = 0; t < TILES && tile0 + t < n_tiles; ++t)
      p[t] = (uint8_t)(bytes >> (8 * t));
  }
}

__global__ void __launch_bounds__(THREADS) epoch_cull_kernel(
    const float* __restrict__ o, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tbest,
    const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ box, const int* __restrict__ n_live,
    int n_clusters, int n_real, int n_tiles, uint8_t* __restrict__ out) {
  __shared__ float4 s_box[2][CHUNK];
  // per warp and 32-box word: the words of its RPT subtiles
  __shared__ uint4 s_bits[THREADS / 32][CHUNK / 32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * TILES;
  const int c_begin = blockIdx.y * CLUSTERS_PER_BLOCK;
  const int c_end = min(n_clusters, c_begin + CLUSTERS_PER_BLOCK);
  const int live = *n_live;
  if (tile0 * TILE >= live) {  // only dead tiles: zeros, no tests
    for (int c = c_begin + threadIdx.x; c < c_end; c += THREADS)
      store_bytes(out, c, n_tiles, tile0, 0u);
    return;
  }

  // a dead tile's rays get tmin NaN: every comparison with it fails, so
  // they set no bit, padding clusters included, and never block a skip
  const int tile = tile0 + warp / 2;
  const bool tile_live = tile < n_tiles && tile * TILE < live;
  const float4 smin = make_float4(box[0], box[1], box[2], 0.f);
  const float4 smax = make_float4(box[3], box[4], box[5], 0.f);
  Ray ray[RPT];
  bool may = false;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    Ray& r = ray[q];
    if (tile_live) {
      const int i = tile0 * TILE + warp * (RPT * 32) + q * 32 + lane;
      r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
      r.ix = inv[3 * i + 0]; r.iy = inv[3 * i + 1]; r.iz = inv[3 * i + 2];
      r.lo = tmin[i]; r.tb = tbest[i]; r.a = w0[i]; r.b = w1[i];
    } else {
      r.ox = r.oy = r.oz = 0.f;
      r.ix = r.iy = r.iz = 1.f;
      r.lo = __int_as_float(0x7fffffff);
      r.tb = r.a = r.b = 0.f;
    }
    float tn, tf;
    slab(r, smin, smax, tn, tf);
    may |= may_hit(r, tn, tf);
  }
  const bool skip = !__any_sync(FULL, may);
  const bool all_skip = __syncthreads_and(skip);

  // real clusters of this block: [c_begin, c_real)
  const int c_real = max(c_begin, min(c_end, n_real));
  int c_first = c_begin;
  if (all_skip) {
    for (int c = c_begin + threadIdx.x; c < c_real; c += THREADS)
      store_bytes(out, c, n_tiles, tile0, 0u);
    c_first = c_real;
  }
  const int warp_first = skip ? c_real : c_first;  // first box it must test

  for (int base = c_first; base < c_end; base += CHUNK) {
    const int cnt = min(CHUNK, c_end - base);
    __syncthreads();
    {
      const int k = threadIdx.x;  // THREADS == CHUNK; NaN boxes pad the chunk
      const float nan = __int_as_float(0x7fffffff);
      float4 lo = make_float4(nan, nan, nan, nan), hi = lo;
      if (k < cnt) {
        const int c = base + k;
        lo = make_float4(cmin[3 * c + 0], cmin[3 * c + 1], cmin[3 * c + 2],
                         0.f);
        hi = make_float4(cmax[3 * c + 0], cmax[3 * c + 1], cmax[3 * c + 2],
                         0.f);
      }
      s_box[0][k] = lo;
      s_box[1][k] = hi;
    }
    __syncthreads();
    const int words = (cnt + 31) / 32;
    // a skipping warp's words wholly below c_real stay 0; from the word
    // holding c_real on it tests every box, the real ones giving 0 exactly
    const int w_first = max(0, warp_first - base) / 32;
    for (int kw = 0; kw < words; ++kw) {
      uint32_t bits[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) bits[q] = 0u;
      if (kw >= w_first) {
#pragma unroll 1
        for (int g = 0; g < 32; g += STEP) {
          uint32_t step_bits[RPT];
#pragma unroll
          for (int q = 0; q < RPT; ++q) step_bits[q] = 0u;
#pragma unroll
          for (int j = 0; j < STEP; ++j) {
            const int k = kw * 32 + g + j;
            const float4 lo = s_box[0][k], hi = s_box[1][k];
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              float tn, tf;
              slab(ray[q], lo, hi, tn, tf);
              if (window_hit(ray[q], tn, tf)) step_bits[q] |= 1u << j;
            }
          }
#pragma unroll
          for (int q = 0; q < RPT; ++q) bits[q] |= step_bits[q] << g;
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) bits[q] = __reduce_or_sync(FULL, bits[q]);
      }
      if (lane == 0)
        s_bits[warp][kw] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    }
    __syncthreads();
    const int k = threadIdx.x;
    if (k < cnt) {
      const int kw = k >> 5, kb = k & 31;
      uint32_t bytes = 0u;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        const uint4 v = s_bits[w][kw];
        const uint32_t nib = ((v.x >> kb) & 1u) | (((v.y >> kb) & 1u) << 1) |
                             (((v.z >> kb) & 1u) << 2) |
                             (((v.w >> kb) & 1u) << 3);
        bytes |= nib << (4 * w);  // warp w: tile w / 2, bits 4(w % 2)..+3
      }
      store_bytes(out, base + k, n_tiles, tile0, bytes);
    }
  }
}

extern "C" int epoch_cull(const void* o, const void* inv, const void* tmin,
                          const void* tbest, const void* w0, const void* w1,
                          const void* cmin, const void* cmax, const void* box,
                          const void* n_live, int n_clusters, int n_real,
                          int n_tiles, void* out, void* stream) {
  if (n_tiles > 0 && n_clusters > 0) {
    const dim3 grid((n_tiles + TILES - 1) / TILES,
                    (n_clusters + CLUSTERS_PER_BLOCK - 1) / CLUSTERS_PER_BLOCK);
    epoch_cull_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)inv, (const float*)tmin,
        (const float*)tbest, (const float*)w0, (const float*)w1,
        (const float*)cmin, (const float*)cmax, (const float*)box,
        (const int*)n_live, n_clusters, n_real, n_tiles, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
