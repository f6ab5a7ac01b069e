// Pair pass of the cluster engine: Möller–Trumbore of each ray tile against
// the triangles of every cluster its kept pairs name, one block per tile,
// one thread per ray, the running best in registers.
//
// Replaces: raytrace_tpu/ops/cluster_intersect.py `_pair_kernel` (launched
// by `intersect_clusters` once per round of 2^17 pairs), which visits one
// (tile, cluster) pair per grid step, tests the tile's rays against the
// cluster's [9, S] slab on the VPU and folds the result into the tile's
// output block; the rounds are min-combined outside the kernel.
//
// Bound on the H100: fp32 instruction throughput — 53 operations per
// ray-triangle test (as K1), against 36 bytes per triangle that every ray of
// the tile shares, read once per pair.
//
// Design: the pairs arrive sorted tile-major and, inside a tile, by
// ascending cluster, so block `tile` walks its own range [begin, end) of
// the list with no atomics and no second pass. For each pair the block
// stages the cluster's triangles in shared memory as v0, e1 = v1 - v0 and
// e2 = v2 - v0 (the differences JAX forms per test, formed once; 18 KB at
// S = 512), and every thread scans k ascending with a strict `<` against
// min(tmax, 1e30, running best). The first triangle at the smallest t wins,
// and since the index cluster·S + k grows with (cluster, k), that is the
// smallest t, then the lowest index: the winner of JAX's per-round strict
// `<` fold and its min-combine across rounds. A tile without a kept pair
// writes the defined miss (1e30, 0). Operation order is JAX's, and the
// library is built with --fmad=false, so (t, idx) equal the plain version's
// bit for bit.
#include <cuda_runtime.h>

#define BIG 1e30f
#define MAX_THREADS 1024

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void cluster_pair_kernel(
    const int* __restrict__ pair_cluster, const int* __restrict__ tile_begin,
    const int* __restrict__ tile_end, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const float* __restrict__ tv, int S,
    float* __restrict__ t_out, int* __restrict__ i_out) {
  extern __shared__ float s_tri[];  // [9][S]: v0, e1, e2, xyz each
  const int tile = blockIdx.x;
  const size_t r = (size_t)tile * blockDim.x + threadIdx.x;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float lo = tmin[r];
  float hi = nan_min(tmax[r], BIG);
  float best_t = BIG;
  int best_i = 0;

  const int p1 = tile_end[tile];
  for (int p = tile_begin[tile]; p < p1; ++p) {
    const int c = pair_cluster[p];
    const float* __restrict__ tri = tv + (size_t)c * 9 * S;
    __syncthreads();  // the previous cluster's triangles are used up
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      const float v0x = tri[0 * S + k], v0y = tri[1 * S + k];
      const float v0z = tri[2 * S + k];
      s_tri[0 * S + k] = v0x;
      s_tri[1 * S + k] = v0y;
      s_tri[2 * S + k] = v0z;
      s_tri[3 * S + k] = tri[3 * S + k] - v0x;
      s_tri[4 * S + k] = tri[4 * S + k] - v0y;
      s_tri[5 * S + k] = tri[5 * S + k] - v0z;
      s_tri[6 * S + k] = tri[6 * S + k] - v0x;
      s_tri[7 * S + k] = tri[7 * S + k] - v0y;
      s_tri[8 * S + k] = tri[8 * S + k] - v0z;
    }
    __syncthreads();
    for (int k = 0; k < S; ++k) {
      const float v0x = s_tri[0 * S + k], v0y = s_tri[1 * S + k];
      const float v0z = s_tri[2 * S + k];
      const float e1x = s_tri[3 * S + k], e1y = s_tri[4 * S + k];
      const float e1z = s_tri[5 * S + k];
      const float e2x = s_tri[6 * S + k], e2y = s_tri[7 * S + k];
      const float e2z = s_tri[8 * S + k];
      // pvec = d x e2
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float inv_det = det != 0.f ? 1.f / det : 0.f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float beta = (tvx * px + tvy * py + tvz * pz) * inv_det;
      // qvec = tvec x e1
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float gamma = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (det != 0.f && beta >= 0.f && gamma >= 0.f && beta + gamma <= 1.f &&
          t > lo && t < hi) {
        best_t = t;
        hi = t;
        best_i = c * S + k;
      }
    }
  }
  t_out[r] = best_t;
  i_out[r] = best_i;
}

extern "C" int cluster_pair(const void* pair_cluster, const void* tile_begin,
                            const void* tile_end, int n_tiles, int tile_rays,
                            const void* o, const void* d, const void* tmin,
                            const void* tmax, const void* tv, int S,
                            void* t_out, void* i_out, void* stream) {
  if (tile_rays <= 0 || tile_rays % 32 || tile_rays > MAX_THREADS || S <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)9 * S * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles > 0) {
    cluster_pair_kernel<<<n_tiles, tile_rays, smem, (cudaStream_t)stream>>>(
        (const int*)pair_cluster, (const int*)tile_begin,
        (const int*)tile_end, (const float*)o, (const float*)d,
        (const float*)tmin, (const float*)tmax, (const float*)tv, S,
        (float*)t_out, (int*)i_out);
  }
  return (int)cudaGetLastError();
}
