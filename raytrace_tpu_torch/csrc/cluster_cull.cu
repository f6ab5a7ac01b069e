// Tile cull of the cluster engine: one byte per (ray tile, cluster), set
// when any ray of the tile crosses the cluster's box inside its
// [tmin, tmax] segment.
//
// Replaces: raytrace_tpu/ops/cluster_intersect.py `_cull_kernel` (launched
// by `_cull`), which tests groups of 8 tiles of 128 or 256 rays against
// 2,048-cluster chunks as dense [tile_rays, chunk] blocks, reduces each
// tile's rows with a max and writes f32 0/1 [n_tiles, C].
//
// Bound on the H100: fp32 instruction throughput. Each ray-box test is 27
// operations (6 differences, 6 products, 3 min and 3 max per slab, 2 max
// and 2 min across the slabs, 3 compares, 2 ands) on 24 bytes of box that
// every ray of a tile shares; the output is one byte per 128 or 256 tests,
// so memory moves little next to the arithmetic.
//
// Design: one block per tile, one ray per thread, so a tile is 4 or 8
// warps; each warp's `__ballot_sync` says whether any of its 32 rays hits a
// box, and the warps' answers are OR-ed through shared memory. Cluster boxes
// stream through shared memory in chunks of 256 and are read as broadcasts;
// a second grid axis splits the clusters into ranges of 1,024 so that
// small launches still fill the card. The mask is tile-major, uint8
// [n_tiles, C], the flat order in which the pair compaction reads it, and
// each chunk's bytes are written by consecutive threads. Every tile and
// every box is tested, padded rays and padding clusters included, as in
// JAX: a padding cluster's (+inf, -inf) box gives the slab (-inf, +inf) and
// passes for every ray. min/max propagate NaN like jnp.minimum, and the
// library is built with --fmad=false and IEEE division, so the mask equals
// the plain version's byte for byte.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WARPS 8
#define CHUNK 256
#define CLUSTERS_PER_BLOCK 1024

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void cluster_cull_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    int n_clusters, uint8_t* __restrict__ out) {
  __shared__ float s_box[6][CHUNK];
  __shared__ unsigned char s_any[MAX_WARPS][CHUNK];

  const int tile = blockIdx.x;
  const int c_begin = blockIdx.y * CLUSTERS_PER_BLOCK;
  const int c_end = min(n_clusters, c_begin + CLUSTERS_PER_BLOCK);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r = (size_t)tile * blockDim.x + threadIdx.x;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const float lo = tmin[r], hi = tmax[r];

  for (int base = c_begin; base < c_end; base += CHUNK) {
    const int cnt = min(CHUNK, c_end - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      for (int ax = 0; ax < 3; ++ax) {
        s_box[ax][k] = cmin[3 * (base + k) + ax];
        s_box[3 + ax][k] = cmax[3 * (base + k) + ax];
      }
    }
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float tx0 = (s_box[0][k] - ox) * ix, tx1 = (s_box[3][k] - ox) * ix;
      const float ty0 = (s_box[1][k] - oy) * iy, ty1 = (s_box[4][k] - oy) * iy;
      const float tz0 = (s_box[2][k] - oz) * iz, tz1 = (s_box[5][k] - oz) * iz;
      const float tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_min(tz0, tz1));
      const float tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                               nan_max(tz0, tz1));
      const bool hit = tn <= tf && tf > lo && tn < hi;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_any[warp][k] = m != 0u;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      unsigned any = 0;
      for (int w = 0; w < warps; ++w) any |= s_any[w][k];
      out[(size_t)tile * n_clusters + base + k] = (uint8_t)any;
    }
  }
}

extern "C" int cluster_cull(const void* o, const void* d, const void* tmin,
                            const void* tmax, const void* cmin,
                            const void* cmax, int n_clusters, int n_tiles,
                            int tile_rays, void* out, void* stream) {
  if (tile_rays <= 0 || tile_rays % 32 || tile_rays > 32 * MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && n_clusters > 0) {
    const dim3 grid(n_tiles,
                    (n_clusters + CLUSTERS_PER_BLOCK - 1) / CLUSTERS_PER_BLOCK);
    cluster_cull_kernel<<<grid, tile_rays, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const float*)cmin, (const float*)cmax,
        n_clusters, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
