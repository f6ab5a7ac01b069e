// Dense Möller–Trumbore closest hit: each ray's nearest triangle (t, idx).
//
// Replaces: raytrace_tpu/ops/pallas_intersect.py `_kernel` (launched by
// `intersect_triangles_pallas`), which tests 128-ray tiles against
// 512-triangle chunks as dense [TR, TC] blocks and keeps a running
// (t, idx, beta, gamma) per ray in VMEM. Its caller re-intersects the
// winner for beta, gamma and a differentiable t, so this kernel returns
// only the winner's t and index.
//
// Bound on the H100: fp32 instruction issue on the range K1 serves — every
// triangle scene under the builder's 512-triangle BVH threshold; at 511
// triangles a 262,144-ray launch is ~7e9 operations against ~10 MB. On
// the Cornell box (10 triangles) a launch is a few microseconds and the
// caller's host time sets the pace. The design makes each shared triangle
// load serve several tests and skips work no hit can need (K9's levers):
//
// - Triangles are staged once per block in shared memory as v0, e1 =
//   v1 - v0 and e2 = v2 - v0 (the plain version's fp32 differences), 36
//   bytes a triangle read back as two 128-bit and one 32-bit broadcast
//   load. A chunk is 512 triangles (18 KB), so a scene under the BVH
//   threshold is one chunk and a launch has one barrier.
// - Two rays per thread (r and r + BLOCK of the block's 2·BLOCK rays), so
//   each triangle load serves two tests; the test loop is unrolled 8 times.
// - Exact early-outs at warp granularity. A warp whose 64 rays all have an
//   empty window !(tmin < tmax) tests nothing. Each test runs in two
//   halves: pvec, det, 1/det, tvec and beta; then qvec, gamma and t. A hit
//   needs det != 0 and 0 <= beta <= 1, so a warp none of whose 32 rays of
//   a slot meets that skips the second half for that triangle.
//
// Each ray keeps its running best with strict `<` in triangle order, so the
// lowest index among equal t wins — the TPU kernel's rule (lowest lane
// within a chunk, strict `<` across chunks). A miss gives (1e30, 0). The
// reciprocal is IEEE round-to-nearest (`__frcp_rn`, the correctly rounded
// 1/det of the plain version); where det is 0 the test fails on
// `det != 0` whatever the reciprocal gives. Operation order is the plain
// version's and the library is built with --fmad=false, so (t, idx) equal
// the plain version's bit for bit.
#include <cuda_runtime.h>

#define BIG 1e30f
#define BLOCK 128
#define RAYS 2                // rays per thread
#define CHUNK 512             // triangles staged per pass
#define FULL 0xffffffffu

struct Ray {
  float ox, oy, oz, dx, dy, dz, lo, hi;
};

// the first half of a ray-triangle test, the plain version's operations in
// its order: pvec, det, its reciprocal, tvec and beta. A hit needs det != 0
// and 0 <= beta <= 1 (beta + gamma <= 1 with gamma >= 0 rounds to at least
// beta), so where this is false for a whole warp the second half cannot
// change its best
struct Half {
  float px, py, pz, inv_det, tvx, tvy, tvz, beta;
  bool pass;
};

__device__ __forceinline__ Half mt_begin(const Ray& r, float4 a, float4 b,
                                         float e2z) {
  // a = (v0x, v0y, v0z, e1x), b = (e1y, e1z, e2x, e2y)
  Half h;
  // pvec = d x e2
  h.px = r.dy * e2z - r.dz * b.w;
  h.py = r.dz * b.z - r.dx * e2z;
  h.pz = r.dx * b.w - r.dy * b.z;
  const float det = a.w * h.px + b.x * h.py + b.y * h.pz;
  h.inv_det = __frcp_rn(det);
  h.tvx = r.ox - a.x; h.tvy = r.oy - a.y; h.tvz = r.oz - a.z;
  h.beta = (h.tvx * h.px + h.tvy * h.py + h.tvz * h.pz) * h.inv_det;
  h.pass = det != 0.f && h.beta >= 0.f && h.beta <= 1.f;
  return h;
}

// the second half: qvec, gamma, t and the bounds; the running best moves
// on a strict `<`
__device__ __forceinline__ void mt_end(const Ray& r, const Half& h, float4 a,
                                       float4 b, float e2z, int k,
                                       float& best_t, int& best_k) {
  // qvec = tvec x e1
  const float qx = h.tvy * b.y - h.tvz * b.x;
  const float qy = h.tvz * a.w - h.tvx * b.y;
  const float qz = h.tvx * b.x - h.tvy * a.w;
  const float gamma = (r.dx * qx + r.dy * qy + r.dz * qz) * h.inv_det;
  const float t = (b.z * qx + b.w * qy + e2z * qz) * h.inv_det;
  const bool ok = h.pass && gamma >= 0.f && h.beta + gamma <= 1.f &&
                  t > r.lo && t < r.hi;
  if (ok && t < best_t) {
    best_t = t;
    best_k = k;
  }
}

__global__ void __launch_bounds__(BLOCK) tri_closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2, int n, int n_tris,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  // v0x v0y v0z e1x | e1y e1z e2x e2y | e2z of each staged triangle
  __shared__ float4 s_a[CHUNK], s_b[CHUNK];
  __shared__ float s_c[CHUNK];

  Ray ray[RAYS];
  bool live = false;
#pragma unroll
  for (int h = 0; h < RAYS; ++h) {
    const int i = blockIdx.x * (RAYS * BLOCK) + h * BLOCK + threadIdx.x;
    Ray& r = ray[h];
    if (i < n) {
      r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
      r.dx = d[3 * i + 0]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
      r.lo = tmin[i]; r.hi = tmax[i];
    } else {  // past the batch: an empty window, never written
      r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.f;
      r.lo = r.hi = 0.f;
    }
    live = live || r.lo < r.hi;
  }
  live = __any_sync(FULL, live);
  float best_t[RAYS];
  int best_k[RAYS];
#pragma unroll
  for (int h = 0; h < RAYS; ++h) {
    best_t[h] = BIG;
    best_k[h] = 0;
  }

  for (int base = 0; base < n_tris; base += CHUNK) {
    const int cnt = min(CHUNK, n_tris - base);
    if (base > 0) __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += BLOCK) {
      const int g = 3 * (base + k);
      const float v0x = v0[g], v0y = v0[g + 1], v0z = v0[g + 2];
      s_a[k] = make_float4(v0x, v0y, v0z, v1[g] - v0x);
      s_b[k] = make_float4(v1[g + 1] - v0y, v1[g + 2] - v0z, v2[g] - v0x,
                           v2[g + 1] - v0y);
      s_c[k] = v2[g + 2] - v0z;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 8  // the loop's own instructions, amortised
    for (int k = 0; k < cnt; ++k) {
      const float4 a = s_a[k], b = s_b[k];
      const float e2z = s_c[k];
      Half half[RAYS];
#pragma unroll
      for (int h = 0; h < RAYS; ++h) half[h] = mt_begin(ray[h], a, b, e2z);
#pragma unroll
      for (int h = 0; h < RAYS; ++h)
        if (__any_sync(FULL, half[h].pass))  // warp-uniform
          mt_end(ray[h], half[h], a, b, e2z, base + k, best_t[h],
                 best_k[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < RAYS; ++h) {
    const int i = blockIdx.x * (RAYS * BLOCK) + h * BLOCK + threadIdx.x;
    if (i < n) {
      t_out[i] = best_t[h];
      idx_out[i] = best_k[h];
    }
  }
}

extern "C" int tri_closest(const void* o, const void* d, const void* tmin,
                           const void* tmax, const void* v0, const void* v1,
                           const void* v2, int n, int n_tris, void* t_out,
                           void* idx_out, void* stream) {
  if (n > 0) {
    const int grid = (n + RAYS * BLOCK - 1) / (RAYS * BLOCK);
    tri_closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const float*)v0, (const float*)v1,
        (const float*)v2, n, n_tris, (float*)t_out, (int*)idx_out);
  }
  return (int)cudaGetLastError();
}
