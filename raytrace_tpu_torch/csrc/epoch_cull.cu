// Epoch-windowed slab cull: one byte per (cluster, 256-ray tile), bit k set
// when a ray of the tile's 32-ray subtile k enters the cluster's box inside
// its current epoch window.
//
// Replaces: raytrace_tpu/ops/epoch_intersect.py `_cull_kernel` (body
// `_cull_kernel_body`, launched by `_cull_bits`), which tests groups of 8
// tiles against 2,048-cluster chunks as dense [256, chunk] blocks, ORs each
// 32-row slice into a bit and writes int32 [n_tiles, C].
//
// Bound on the H100: fp32 instruction throughput. Each ray-cluster test is
// 32 operations (6 differences, 6 products, 11 min/max, 5 compares, 4 ands)
// on 24 bytes of box that every ray of a tile shares; the output is one
// byte per 256 tests, so memory moves little next to the arithmetic.
//
// Design: one block of 256 threads per tile, one ray per thread, so a warp
// is exactly one 32-ray subtile and `__ballot_sync(...) != 0` is the
// subtile's bit. Cluster boxes stream through shared memory in chunks of
// 256 and are read as broadcasts; a second grid axis splits the clusters
// into ranges of 1,024 so small launches still fill the card. The mask is
// written cluster-major, uint8 [C, n_tiles]: the order the pair compaction
// reads (JAX transposes its int32 mask for it) in a quarter of the bytes.
// Tiles past the live prefix (rays sort dead-last) write zeros without
// testing; the live count is read on the device, so the host never waits.
// min/max propagate NaN like jnp.minimum/torch.minimum, and the library is
// built with --fmad=false, so the mask equals the plain version's bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256
#define NSUB 8
#define CHUNK 256
#define CLUSTERS_PER_BLOCK 1024

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void epoch_cull_kernel(
    const float* __restrict__ o, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tbest,
    const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const int* __restrict__ n_live, int n_clusters, int n_tiles,
    uint8_t* __restrict__ out) {
  __shared__ float s_box[6][CHUNK];
  __shared__ unsigned char s_bits[NSUB][CHUNK];

  const int tile = blockIdx.x;
  const int c_begin = blockIdx.y * CLUSTERS_PER_BLOCK;
  const int c_end = min(n_clusters, c_begin + CLUSTERS_PER_BLOCK);
  if (tile * TILE >= *n_live) {  // only dead rays: zeros, no tests
    for (int c = c_begin + threadIdx.x; c < c_end; c += blockDim.x)
      out[(size_t)c * n_tiles + tile] = 0;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = tile * TILE + threadIdx.x;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float ix = inv[3 * r + 0], iy = inv[3 * r + 1], iz = inv[3 * r + 2];
  const float lo = tmin[r], tb = tbest[r], a = w0[r], b = w1[r];

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
      // the entry distance clamped to the ray start puts each cluster in
      // exactly one epoch window [w0, w1); resolved rays cull nothing
      const float tnc = nan_max(tn, lo);
      const bool hit = tn <= tf && tf > lo && tnc >= a && tnc < b && tnc < tb;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_bits[warp][k] = m != 0u;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      unsigned byte = 0;
      for (int w = 0; w < NSUB; ++w) byte |= (unsigned)s_bits[w][k] << w;
      out[(size_t)(base + k) * n_tiles + tile] = (uint8_t)byte;
    }
  }
}

extern "C" int epoch_cull(const void* o, const void* inv, const void* tmin,
                          const void* tbest, const void* w0, const void* w1,
                          const void* cmin, const void* cmax,
                          const void* n_live, int n_clusters, int n_tiles,
                          void* out, void* stream) {
  if (n_tiles > 0 && n_clusters > 0) {
    const dim3 grid(n_tiles,
                    (n_clusters + CLUSTERS_PER_BLOCK - 1) / CLUSTERS_PER_BLOCK);
    epoch_cull_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)inv, (const float*)tmin,
        (const float*)tbest, (const float*)w0, (const float*)w1,
        (const float*)cmin, (const float*)cmax, (const int*)n_live,
        n_clusters, n_tiles, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
