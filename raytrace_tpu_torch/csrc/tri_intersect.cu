// Dense Möller–Trumbore closest hit, one thread per ray.
//
// Replaces: raytrace_tpu/ops/pallas_intersect.py `_kernel` (launched by
// `intersect_triangles_pallas`), which tests 128-ray tiles against
// 512-triangle chunks as dense [TR, TC] blocks and keeps a running
// (t, idx, beta, gamma) per ray in VMEM.
//
// Bound on the H100: FP32 instruction throughput. On the main path (the
// Cornell box, 10 triangles) every ray does ~10 x 30 fp32 ops and reads 40
// bytes, so the pair tests, not memory, set the time; with thousands of
// triangles it is the same per pair, times the triangle count.
//
// Design: each thread owns one ray in registers and loops over the
// triangles in index order; blocks stage triangle chunks (v0, e1 = v1-v0,
// e2 = v2-v0) through shared memory, so a triangle's 9 floats are read from
// device memory once per block, and all threads read the same shared word
// (a broadcast). The strict `t < best` in index order keeps the lowest
// index among equal t — the TPU kernel's rule (lowest lane within a chunk,
// strict `<` across chunks). A miss leaves t = 1e30, idx = 0, beta = gamma
// = 0. The library is built with --fmad=false so every product and sum
// rounds as in the plain PyTorch version: no fused multiply-add moves a
// grazing hit across an edge.
#include <cuda_runtime.h>

#define BIG 1e30f
#define TRI_TILE 256
#define BLOCK 128

__global__ void tri_closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2, int n, int n_tris,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ beta_out, float* __restrict__ gamma_out) {
  __shared__ float s_v0[3][TRI_TILE];
  __shared__ float s_e1[3][TRI_TILE];
  __shared__ float s_e2[3][TRI_TILE];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float lo = 0.f, hi = 0.f;
  if (live) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    lo = tmin[i]; hi = tmax[i];
  }
  float best_t = BIG, best_b = 0.f, best_g = 0.f;
  int best_i = 0;

  for (int base = 0; base < n_tris; base += TRI_TILE) {
    const int cnt = min(TRI_TILE, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const int g = 3 * (base + k);
      for (int c = 0; c < 3; ++c) {
        const float a = v0[g + c];
        s_v0[c][k] = a;
        s_e1[c][k] = v1[g + c] - a;
        s_e2[c][k] = v2[g + c] - a;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < cnt; ++k) {
      const float e1x = s_e1[0][k], e1y = s_e1[1][k], e1z = s_e1[2][k];
      const float e2x = s_e2[0][k], e2y = s_e2[1][k], e2z = s_e2[2][k];
      // pvec = d x e2
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float inv_det = det != 0.f ? 1.f / det : 0.f;
      const float tvx = ox - s_v0[0][k];
      const float tvy = oy - s_v0[1][k];
      const float tvz = oz - s_v0[2][k];
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
        best_t = t; best_i = base + k; best_b = beta; best_g = gamma;
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
    beta_out[i] = best_b;
    gamma_out[i] = best_g;
  }
}

extern "C" int tri_closest(const void* o, const void* d, const void* tmin,
                           const void* tmax, const void* v0, const void* v1,
                           const void* v2, int n, int n_tris, void* t_out,
                           void* idx_out, void* beta_out, void* gamma_out,
                           void* stream) {
  if (n > 0) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    tri_closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const float*)v0, (const float*)v1,
        (const float*)v2, n, n_tris, (float*)t_out, (int*)idx_out,
        (float*)beta_out, (float*)gamma_out);
  }
  return (int)cudaGetLastError();
}
