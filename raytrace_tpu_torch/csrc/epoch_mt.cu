// Möller–Trumbore of 32-ray subtiles against one cluster's triangles, per
// job (cluster, subtile): each lane's closest hit and its triangle index.
//
// Replaces: raytrace_tpu/ops/epoch_intersect.py `_mt_kernel` (launched by
// `_mt_rounds`), which tests JPS = 4 subtiles × one cluster's [9, S] slab
// per grid step on the VPU and writes each job's (t, idx) row; the
// per-subtile min-combine runs outside the kernel.
//
// Bound on the H100: fp32 instruction issue — 53 operations per
// ray-triangle test (as K1), against 36 bytes per triangle that all rays of
// a job share. Loads compete with that arithmetic for issue slots, so the
// design makes each triangle load serve several tests:
//
// - One block per group of JOBS = 4 consecutive jobs. The engine pads each
//   cluster's run of jobs to a multiple of 4, as JAX aligns its job list,
//   so an aligned group names one cluster: the block stages that cluster's
//   v0, e1 = v1 − v0 and e2 = v2 − v0 once in shared memory (the plain
//   version's fp32 differences) as 36 bytes a triangle, read back as two
//   128-bit and one 32-bit broadcast load.
// - Two rays per thread, one from each of a warp's two jobs, so each
//   triangle load serves two tests; the test loop is unrolled 8 times to
//   amortise the loop's own instructions.
// - Exact early-outs at warp granularity. A warp whose 64 rays all have an
//   empty window !(tmin < tmax) writes the miss rows untested:
//   `t > tmin && t < tmax` cannot hold for them. Each test runs in two
//   halves: pvec, det, 1/det, tvec and beta; then qvec, gamma and t. A hit
//   needs det != 0 and 0 <= beta <= 1, so a warp none of whose 32 rays of
//   a job meets that skips the second half (about 21 of the 53 operations)
//   for that job and triangle.
// - A group whose jobs name different clusters (any job list the engine
//   does not build) is still exact: each job then reads its own cluster's
//   triangles from global memory, one ray per thread.
//
// Each ray keeps its running best with strict `<` in triangle order, so the
// first triangle at the minimum t wins — JAX's rule within a job. A job
// without a hit writes (1e30, cluster·S). The reciprocal is IEEE
// round-to-nearest (`__frcp_rn`, the correctly rounded 1/det of the plain
// version); where det is 0 the test fails on `det != 0` whatever the
// reciprocal gives. Operation order is the plain version's and the library
// is built with --fmad=false, so (t, idx) equal the plain version's bit for
// bit.
#include <cuda_runtime.h>

#define BIG 1e30f
#define SUB 32
#define JOBS 4                // jobs per block
#define WARPS (JOBS / 2)      // two jobs per warp
#define CHUNK 256             // triangles staged per pass
#define FULL 0xffffffffu

struct Ray {
  float ox, oy, oz, dx, dy, dz, lo, hi;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax,
                                        int r) {
  Ray ray;
  ray.ox = o[3 * r + 0]; ray.oy = o[3 * r + 1]; ray.oz = o[3 * r + 2];
  ray.dx = d[3 * r + 0]; ray.dy = d[3 * r + 1]; ray.dz = d[3 * r + 2];
  ray.lo = tmin[r]; ray.hi = tmax[r];
  return ray;
}

// the first half of a ray-triangle test, the plain version's operations
// in its order: pvec, det, its reciprocal, tvec and beta. A hit needs
// det != 0 and 0 <= beta <= 1 (beta + gamma <= 1 with gamma >= 0 rounds to
// at least beta), so where this is false for a whole warp the second half
// cannot change its best
struct Half {
  float px, py, pz, inv_det, tvx, tvy, tvz, beta;
  bool pass;
};

__device__ __forceinline__ Half mt_begin(const Ray& r, float v0x, float v0y,
                                         float v0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y,
                                         float e2z) {
  Half h;
  // pvec = d x e2
  h.px = r.dy * e2z - r.dz * e2y;
  h.py = r.dz * e2x - r.dx * e2z;
  h.pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * h.px + e1y * h.py + e1z * h.pz;
  h.inv_det = __frcp_rn(det);
  h.tvx = r.ox - v0x; h.tvy = r.oy - v0y; h.tvz = r.oz - v0z;
  h.beta = (h.tvx * h.px + h.tvy * h.py + h.tvz * h.pz) * h.inv_det;
  h.pass = det != 0.f && h.beta >= 0.f && h.beta <= 1.f;
  return h;
}

// the second half: qvec, gamma, t and the bounds; the running best moves
// on a strict `<`
__device__ __forceinline__ void mt_end(const Ray& r, const Half& h,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z, int k,
                                       float& best_t, int& best_k) {
  // qvec = tvec x e1
  const float qx = h.tvy * e1z - h.tvz * e1y;
  const float qy = h.tvz * e1x - h.tvx * e1z;
  const float qz = h.tvx * e1y - h.tvy * e1x;
  const float gamma = (r.dx * qx + r.dy * qy + r.dz * qz) * h.inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * h.inv_det;
  const bool ok = h.pass && gamma >= 0.f && h.beta + gamma <= 1.f &&
                  t > r.lo && t < r.hi;
  if (ok && t < best_t) {
    best_t = t;
    best_k = k;
  }
}

// one ray-triangle test
__device__ __forceinline__ void mt_test(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, int k, float& best_t,
                                        int& best_k) {
  const Half h = mt_begin(r, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z);
  mt_end(r, h, e1x, e1y, e1z, e2x, e2y, e2z, k, best_t, best_k);
}

// one job from global memory, one ray per thread: the path for groups whose
// jobs name different clusters
__device__ void job_from_global(const Ray& r, const float* __restrict__ tri,
                                int S, float& best_t, int& best_k) {
  for (int k = 0; k < S; ++k) {
    const float v0x = __ldg(tri + 0 * S + k), v0y = __ldg(tri + 1 * S + k);
    const float v0z = __ldg(tri + 2 * S + k);
    mt_test(r, v0x, v0y, v0z, __ldg(tri + 3 * S + k) - v0x,
            __ldg(tri + 4 * S + k) - v0y, __ldg(tri + 5 * S + k) - v0z,
            __ldg(tri + 6 * S + k) - v0x, __ldg(tri + 7 * S + k) - v0y,
            __ldg(tri + 8 * S + k) - v0z, k, best_t, best_k);
  }
}

__global__ void __launch_bounds__(WARPS * SUB) epoch_mt_kernel(
    const int* __restrict__ job_cluster, const int* __restrict__ job_subtile,
    int n_jobs, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ tv, int S, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  // v0x v0y v0z e1x | e1y e1z e2x e2y | e2z of each staged triangle
  __shared__ float4 s_a[CHUNK], s_b[CHUNK];
  __shared__ float s_c[CHUNK];

  const int j0 = blockIdx.x * JOBS;
  const int nj = min(JOBS, n_jobs - j0);
  const int c = job_cluster[j0];
  bool uniform = true;
  for (int j = 1; j < nj; ++j) uniform = uniform && job_cluster[j0 + j] == c;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int job[2] = {j0 + 2 * warp, j0 + 2 * warp + 1};
  float best_t[2] = {BIG, BIG};
  int best_k[2] = {0, 0};

  if (!uniform) {  // block-uniform: no barrier below is skipped by half
    for (int h = 0; h < 2; ++h) {
      if (job[h] >= n_jobs) continue;
      const int cj = job_cluster[job[h]];
      const Ray r = load_ray(o, d, tmin, tmax,
                             job_subtile[job[h]] * SUB + lane);
      job_from_global(r, tv + (size_t)cj * 9 * S, S, best_t[h], best_k[h]);
      t_out[(size_t)job[h] * SUB + lane] = best_t[h];
      i_out[(size_t)job[h] * SUB + lane] = cj * S + best_k[h];
    }
    return;
  }

  Ray ray[2];
  bool live = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (job[h] < n_jobs) {
      ray[h] = load_ray(o, d, tmin, tmax, job_subtile[job[h]] * SUB + lane);
    } else {  // past the list: an empty window, never written
      ray[h].ox = ray[h].oy = ray[h].oz = 0.f;
      ray[h].dx = ray[h].dy = ray[h].dz = 0.f;
      ray[h].lo = ray[h].hi = 0.f;
    }
    live = live || ray[h].lo < ray[h].hi;
  }
  live = __any_sync(FULL, live);

  const float* __restrict__ tri = tv + (size_t)c * 9 * S;
  for (int base = 0; base < S; base += CHUNK) {
    const int cnt = min(CHUNK, S - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += WARPS * SUB) {
      const int i = base + k;
      const float v0x = tri[0 * S + i], v0y = tri[1 * S + i],
                  v0z = tri[2 * S + i];
      const float e1x = tri[3 * S + i] - v0x, e1y = tri[4 * S + i] - v0y,
                  e1z = tri[5 * S + i] - v0z;
      const float e2x = tri[6 * S + i] - v0x, e2y = tri[7 * S + i] - v0y,
                  e2z = tri[8 * S + i] - v0z;
      s_a[k] = make_float4(v0x, v0y, v0z, e1x);
      s_b[k] = make_float4(e1y, e1z, e2x, e2y);
      s_c[k] = e2z;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 8  // the loop's own instructions, amortised
    for (int k = 0; k < cnt; ++k) {
      const float4 a = s_a[k], b = s_b[k];
      const float e2z = s_c[k];
      Half half[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        half[h] = mt_begin(ray[h], a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                           e2z);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (__any_sync(FULL, half[h].pass))  // warp-uniform
          mt_end(ray[h], half[h], a.w, b.x, b.y, b.z, b.w, e2z, base + k,
                 best_t[h], best_k[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (job[h] < n_jobs) {
      t_out[(size_t)job[h] * SUB + lane] = best_t[h];
      i_out[(size_t)job[h] * SUB + lane] = c * S + best_k[h];
    }
  }
}

extern "C" int epoch_mt(const void* job_cluster, const void* job_subtile,
                        int n_jobs, const void* o, const void* d,
                        const void* tmin, const void* tmax, const void* tv,
                        int S, void* t_out, void* i_out, void* stream) {
  if (n_jobs > 0) {
    const int grid = (n_jobs + JOBS - 1) / JOBS;
    epoch_mt_kernel<<<grid, WARPS * SUB, 0, (cudaStream_t)stream>>>(
        (const int*)job_cluster, (const int*)job_subtile, n_jobs,
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const float*)tv, S, (float*)t_out,
        (int*)i_out);
  }
  return (int)cudaGetLastError();
}
