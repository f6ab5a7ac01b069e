// Möller–Trumbore of a 32-ray subtile against one cluster's triangles, one
// warp per job (cluster, subtile), one thread per ray.
//
// Replaces: raytrace_tpu/ops/epoch_intersect.py `_mt_kernel` (launched by
// `_mt_rounds`), which tests JPS = 4 subtiles × one cluster's [9, S] slab
// per grid step on the VPU and writes each job's (t, idx) row; the
// per-subtile min-combine runs outside the kernel.
//
// Bound on the H100: fp32 instruction throughput — 53 operations per
// ray-triangle test (as K1), against 36 bytes per triangle that all 32
// lanes of the warp share.
//
// Design: jobs are cluster-major, so neighbouring warps mostly read the same
// cluster; each triangle's 9 floats are read by all lanes at one address
// (a broadcast, served by L1 after the first warp). Each thread keeps its
// ray in registers and the running best with strict `<` in triangle order,
// so the first triangle at the minimum t wins — JAX's rule within a job.
// A job without a hit writes (1e30, cluster·S). Operation order is JAX's,
// and the library is built with --fmad=false, so (t, idx) equal the plain
// version's bit for bit.
#include <cuda_runtime.h>

#define BIG 1e30f
#define SUB 32
#define WARPS 4

__global__ void epoch_mt_kernel(
    const int* __restrict__ job_cluster, const int* __restrict__ job_subtile,
    int n_jobs, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ tv, int S, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  const int job = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (job >= n_jobs) return;
  const int lane = threadIdx.x & 31;
  const int c = job_cluster[job];
  const int r = job_subtile[job] * SUB + lane;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float lo = tmin[r], hi = tmax[r];
  const float* __restrict__ tri = tv + (size_t)c * 9 * S;

  float best_t = BIG;
  int best_k = 0;
  for (int k = 0; k < S; ++k) {
    const float v0x = __ldg(tri + 0 * S + k), v0y = __ldg(tri + 1 * S + k);
    const float v0z = __ldg(tri + 2 * S + k);
    const float e1x = __ldg(tri + 3 * S + k) - v0x;
    const float e1y = __ldg(tri + 4 * S + k) - v0y;
    const float e1z = __ldg(tri + 5 * S + k) - v0z;
    const float e2x = __ldg(tri + 6 * S + k) - v0x;
    const float e2y = __ldg(tri + 7 * S + k) - v0y;
    const float e2z = __ldg(tri + 8 * S + k) - v0z;
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
    const bool ok = det != 0.f && beta >= 0.f && gamma >= 0.f &&
                    beta + gamma <= 1.f && t > lo && t < hi;
    if (ok && t < best_t) {
      best_t = t;
      best_k = k;
    }
  }
  t_out[(size_t)job * SUB + lane] = best_t;
  i_out[(size_t)job * SUB + lane] = c * S + best_k;
}

extern "C" int epoch_mt(const void* job_cluster, const void* job_subtile,
                        int n_jobs, const void* o, const void* d,
                        const void* tmin, const void* tmax, const void* tv,
                        int S, void* t_out, void* i_out, void* stream) {
  if (n_jobs > 0) {
    const int grid = (n_jobs + WARPS - 1) / WARPS;
    epoch_mt_kernel<<<grid, WARPS * SUB, 0, (cudaStream_t)stream>>>(
        (const int*)job_cluster, (const int*)job_subtile, n_jobs,
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const float*)tv, S, (float*)t_out,
        (int*)i_out);
  }
  return (int)cudaGetLastError();
}
