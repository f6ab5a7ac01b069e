// Tile cull of the cluster engine: one byte per (ray tile, cluster), set
// when any ray of the tile crosses the cluster's box inside its
// [tmin, tmax] segment.
//
// Replaces: raytrace_tpu/ops/cluster_intersect.py `_cull_kernel` (launched
// by `_cull`), which tests groups of 8 tiles of 128 or 256 rays against
// 2,048-cluster chunks as dense [tile_rays, chunk] blocks, reduces each
// tile's rows with a max and writes f32 0/1 [n_tiles, C].
//
// Bound on the H100: fp32 instruction issue. Each ray-box test is 27
// operations (6 differences, 6 products, 3 min and 3 max per slab, 2 max
// and 2 min across the slabs, 3 compares, 2 ands) on 24 bytes of box that
// every ray of a tile shares; the output is one byte per 128 or 256 tests,
// so memory moves little next to the arithmetic. The design cuts
// instructions per test and, where it is exact, tests per launch, with the
// levers of the epoch cull (csrc/epoch_cull.cu):
//
// - One warp per tile: four rays a thread for a 128-ray tile, eight for a
//   256-ray tile (the same code, RPT a template argument), so one box — two
//   128-bit broadcast loads from shared memory — serves four or eight
//   tests, and the tile's byte needs no shared memory: each thread ORs its
//   rays' hits into a word over 32 boxes, one `__reduce_or_sync` gives the
//   tile's word, and lane l stores box l's byte, 32 consecutive bytes of
//   the tile's row. Eight rays a thread rather than two warps OR-ed keeps
//   that path free of shared memory too; no config[4] launch takes it (it
//   starts at 2^21 rays), so its extra registers cost nothing measured.
// - min.NaN.f32 / max.NaN.f32 (sm_80+): torch.minimum's NaN rule in one
//   instruction instead of two compares and a select.
// - Exact early-out. Each ray first runs the same test against the scene
//   box S = [smin, smax], which holds every real cluster (index < n_real).
//   x ↦ (x − o)·inv rounds monotonically, so without NaN each real
//   cluster's slab values lie between S's on every axis: tn ≥ tn_S and
//   tf ≤ tf_S. A hit needs tn ≤ tf, tf > tmin and tn < tmax, hence
//   tn_S ≤ tf_S, tf_S > tmin and tn_S < tmax. A NaN among a cluster's slab
//   values makes tn and tf NaN and the cluster misses; a NaN among S's
//   means "may hit". A warp none of whose rays may hit writes 0 for the real
//   clusters untested; a block whose warps all skip stages no boxes for a
//   chunk of real clusters. Padding clusters (index ≥ n_real, boxes
//   (+inf, −inf), whose slab (−inf, +inf) passes every ray without a NaN,
//   the padded rays' too) are always tested. ops/cluster_kernels.py
//   `precull_plain` is the same predicate; tests/test_torch_cluster_precull.py
//   holds it exact. The wrapper passes the real clusters' hull as S;
//   n_real = 0 turns the pre-cull off.
//
// A second grid axis splits the clusters into ranges of 1,024 so that
// small launches still fill the card. The mask stays tile-major, uint8
// [n_tiles, C], the flat order in which the pair compaction reads it. Every
// tile and every box the plain version tests gives its byte, padded rays
// and empty windows included, as in JAX. Operation order is the plain
// version's and the library is built with --fmad=false and IEEE division,
// so the mask equals the plain version's byte for byte.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                      // 8 warps: 8 tiles a block
#define WARPS (THREADS / 32)
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
  float ox, oy, oz, ix, iy, iz, lo, hi;  // tmin, tmax
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

__device__ __forceinline__ bool hit(const Ray& r, float tn, float tf) {
  return tn <= tf && tf > r.lo && tn < r.hi;
}

template <int RPT>
__device__ __forceinline__ void cull_body(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ box, int n_clusters, int n_real, int n_tiles,
    uint8_t* __restrict__ out) {
  __shared__ float4 s_box[2][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + warp;
  const bool live = tile < n_tiles;  // warp-uniform
  const int c_begin = blockIdx.y * CLUSTERS_PER_BLOCK;
  const int c_end = min(n_clusters, c_begin + CLUSTERS_PER_BLOCK);

  Ray ray[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    Ray& r = ray[q];
    if (live) {
      const size_t i = (size_t)tile * (RPT * 32) + q * 32 + lane;
      r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
      const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
      r.ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
      r.iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
      r.iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
      r.lo = tmin[i]; r.hi = tmax[i];
    }
  }
  // real clusters of this block: [c_begin, c_real)
  const int c_real = max(c_begin, min(c_end, n_real));
  bool may = c_real == c_begin;  // no real cluster here: nothing to skip
  if (!may && live) {
    const float4 smin = make_float4(box[0], box[1], box[2], 0.f);
    const float4 smax = make_float4(box[3], box[4], box[5], 0.f);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {  // the scene box's necessary condition
      float tn, tf;
      slab(ray[q], smin, smax, tn, tf);
      may |= tn != tn || hit(ray[q], tn, tf);
    }
  }
  const bool skip = !__any_sync(FULL, may);  // dead warps skip too
  const bool all_skip = __syncthreads_and(skip);
  // a skipping warp's words wholly below c_real are 0 untested; from the
  // word holding c_real on it tests every box, the real ones giving 0
  const int warp_first = skip ? c_real : c_begin;

  for (int base = c_begin; base < c_end; base += CHUNK) {
    const int cnt = min(CHUNK, c_end - base);
    uint8_t* row = out + (size_t)tile * n_clusters + base;
    if (all_skip && base + cnt <= c_real) {  // block-uniform
      for (int k = lane; live && k < cnt; k += 32) row[k] = 0;
      continue;
    }
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
    if (!live) continue;  // warp-uniform
    const int words = (cnt + 31) / 32;
    const int w_first = max(0, warp_first - base) / 32;
    for (int kw = 0; kw < words; ++kw) {
      uint32_t bits = 0u;
      if (kw >= w_first) {
#pragma unroll 1
        for (int g = 0; g < 32; g += STEP) {
          uint32_t step_bits = 0u;
#pragma unroll
          for (int j = 0; j < STEP; ++j) {
            const int k = kw * 32 + g + j;
            const float4 lo = s_box[0][k], hi = s_box[1][k];
            bool any = false;
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              float tn, tf;
              slab(ray[q], lo, hi, tn, tf);
              any |= hit(ray[q], tn, tf);
            }
            if (any) step_bits |= 1u << j;
          }
          bits |= step_bits << g;
        }
        bits = __reduce_or_sync(FULL, bits);
      }
      const int k = kw * 32 + lane;
      if (k < cnt) row[k] = (uint8_t)((bits >> lane) & 1u);
    }
  }
}

// 128-ray tiles (the main path): four rays a thread
__global__ void __launch_bounds__(THREADS) cluster_cull_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ box, int n_clusters, int n_real, int n_tiles,
    uint8_t* __restrict__ out) {
  cull_body<4>(o, d, tmin, tmax, cmin, cmax, box, n_clusters, n_real,
               n_tiles, out);
}

// 256-ray tiles (launches of 2^21 rays and more): eight rays a thread
__global__ void __launch_bounds__(THREADS) cluster_cull_wide_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ box, int n_clusters, int n_real, int n_tiles,
    uint8_t* __restrict__ out) {
  cull_body<8>(o, d, tmin, tmax, cmin, cmax, box, n_clusters, n_real,
               n_tiles, out);
}

extern "C" int cluster_cull(const void* o, const void* d, const void* tmin,
                            const void* tmax, const void* cmin,
                            const void* cmax, const void* box, int n_clusters,
                            int n_real, int n_tiles, int tile_rays, void* out,
                            void* stream) {
  if (tile_rays != 128 && tile_rays != 256)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && n_clusters > 0) {
    const dim3 grid((n_tiles + WARPS - 1) / WARPS,
                    (n_clusters + CLUSTERS_PER_BLOCK - 1) / CLUSTERS_PER_BLOCK);
    const cudaStream_t s = (cudaStream_t)stream;
    if (tile_rays == 128) {
      cluster_cull_kernel<<<grid, THREADS, 0, s>>>(
          (const float*)o, (const float*)d, (const float*)tmin,
          (const float*)tmax, (const float*)cmin, (const float*)cmax,
          (const float*)box, n_clusters, n_real, n_tiles, (uint8_t*)out);
    } else {
      cluster_cull_wide_kernel<<<grid, THREADS, 0, s>>>(
          (const float*)o, (const float*)d, (const float*)tmin,
          (const float*)tmax, (const float*)cmin, (const float*)cmax,
          (const float*)box, n_clusters, n_real, n_tiles, (uint8_t*)out);
    }
  }
  return (int)cudaGetLastError();
}
