// Dense small-map photon gather: every query against the valid prefix of a
// compacted photon map, each warp's photons pre-culled against the warp's
// query box.
//
// Replaces: raytrace_tpu/ops/pallas_gather.py `_kernel` (launched by
// `gather_radius_pallas`). There a (query tile, photon chunk) grid forms
// dense [128, tile_p] blocks, skips chunks past the scalar-prefetched valid
// count, and accumulates per query L += kd * sum_{dist2 < r2, valid}
// |n_s . wi| * alpha and M += count in VMEM across the chunk axis.
//
// Bound on the H100: fp32 instruction issue. Each (query, photon) pair
// costs 10 fp32 operations for the radius test and 13 more inside the
// radius, while the inputs are a few MB (a 2^14-slot map is 640 KB, 262,144
// queries 7 MB). Testing every pair is 2.9e8 tests on the preview's first
// wave, but a warp's queries are 32 neighbouring pixels whose radii span a
// few pixels, and the map's photons lie all over the scene, so almost
// every pair is out of range. The design drops those pairs before the
// test, exactly:
//
// - Each block of 256 threads owns 256 consecutive queries, one a thread
//   (a warp 32 neighbouring pixels), and walks the valid prefix
//   [0, n_valid) in chunks of 512 photons, staged in shared memory as
//   128-bit rows: px py pz valid | wx wy wz ax | ay az (40 bytes a photon).
// - Each warp takes the box of its queries with r2 > 0 and their largest
//   r2, with NaN-ignoring min and max: a query with a NaN position or r2,
//   or r2 <= 0, never counts a photon (`dist2 < r2` is false).
// - The pre-cull: per staged photon and axis the gap g = fl(qmin - p) where
//   p < qmin, fl(p - qmax) where p > qmax, else 0, and G = fl(fl(fl(gx²) +
//   fl(gy²)) + fl(gz²)). Rounding to nearest is monotone, so for every
//   query of the warp each |fl(q - p)| >= g, each square and each sum of
//   non-negative terms keeps that order, and dist2 >= G. A photon with
//   G >= r2max, or an invalid one, can count for no query of the warp and
//   is skipped; a NaN G is kept. The survivors go into the warp's list in
//   shared memory in index order (`__ballot_sync`, `__popc`), and every
//   lane tests the list only, reading each entry as a broadcast.
//
// Per query the sums run over the same terms in the same order (photon
// index) as a test of every pair, so the output does not depend on the
// cull. No atomics and a fixed order: the result is the same in every run.
// n_valid is read from device memory, so the caller never waits for it
// (the TPU kernel's scalar prefetch). The library is built with
// --fmad=false, so dist2, G and each term |n_s . wi| * alpha round as in
// the plain PyTorch version; the two agree on every count M and differ
// only by the order of the sums. kd/pi multiplies once, outside, on the
// sums (the TPU kernel multiplied per chunk).
#include <cuda_runtime.h>

#define BLOCK 256
#define WARPS (BLOCK / 32)
#define CHUNK 512             // photons staged per pass
#define FULL 0xffffffffu

// K5 (csrc/grid_gather.cu) repeats the warp's box, the gap G and the
// survivor list: a change to their exactness argument is made in both
// kernels and in dense_gather.py's `group_box` and `gap2`
__device__ __forceinline__ float gap(float p, float lo, float hi) {
  return p < lo ? lo - p : (p > hi ? p - hi : 0.f);
}

__global__ void __launch_bounds__(BLOCK) dense_gather_kernel(
    const float* __restrict__ qp, const float* __restrict__ qr2,
    const float* __restrict__ qns, const float* __restrict__ pp,
    const float* __restrict__ pal, const float* __restrict__ pwi,
    const unsigned char* __restrict__ pval, int n, int p,
    const int* __restrict__ n_valid, float* __restrict__ out) {
  __shared__ float4 s_a[CHUNK], s_b[CHUNK];
  __shared__ float2 s_c[CHUNK];
  __shared__ unsigned short s_list[WARPS][CHUNK];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * BLOCK + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f, r2 = 0.f, nx = 0.f, ny = 0.f,
        nz = 0.f;
  if (q < n) {
    qx = qp[3 * q]; qy = qp[3 * q + 1]; qz = qp[3 * q + 2];
    r2 = qr2[q];
    nx = qns[3 * q]; ny = qns[3 * q + 1]; nz = qns[3 * q + 2];
  }
  // the warp's box: its queries with r2 > 0, NaN coordinates ignored
  const float inf = __int_as_float(0x7f800000);
  float lox = inf, loy = inf, loz = inf;
  float hix = -inf, hiy = -inf, hiz = -inf, r2max = 0.f;
  if (r2 > 0.f) {
    lox = fminf(lox, qx); loy = fminf(loy, qy); loz = fminf(loz, qz);
    hix = fmaxf(hix, qx); hiy = fmaxf(hiy, qy); hiz = fmaxf(hiz, qz);
    r2max = r2;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lox = fminf(lox, __shfl_xor_sync(FULL, lox, s));
    loy = fminf(loy, __shfl_xor_sync(FULL, loy, s));
    loz = fminf(loz, __shfl_xor_sync(FULL, loz, s));
    hix = fmaxf(hix, __shfl_xor_sync(FULL, hix, s));
    hiy = fmaxf(hiy, __shfl_xor_sync(FULL, hiy, s));
    hiz = fmaxf(hiz, __shfl_xor_sync(FULL, hiz, s));
    r2max = fmaxf(r2max, __shfl_xor_sync(FULL, r2max, s));
  }
  const bool any = r2max > 0.f;  // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  unsigned short* list = s_list[warp];

  float sr = 0.f, sg = 0.f, sb = 0.f, m = 0.f;
  const int nv = min(*n_valid, p);
  for (int base = 0; base < nv; base += CHUNK) {
    const int cnt = min(CHUNK, nv - base);
    if (base > 0) __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += BLOCK) {
      const int g = base + k;
      s_a[k] = make_float4(pp[3 * g], pp[3 * g + 1], pp[3 * g + 2],
                           pval[g] ? 1.f : 0.f);
      s_b[k] = make_float4(pwi[3 * g], pwi[3 * g + 1], pwi[3 * g + 2],
                           pal[3 * g]);
      s_c[k] = make_float2(pal[3 * g + 1], pal[3 * g + 2]);
    }
    __syncthreads();
    if (!any) continue;
    int len = 0;
#pragma unroll 1
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      const int k = k0 + lane;
      bool keep = false;
      if (k < cnt) {
        const float4 a = s_a[k];
        const float gx = gap(a.x, lox, hix), gy = gap(a.y, loy, hiy),
                    gz = gap(a.z, loz, hiz);
        const float G = gx * gx + gy * gy + gz * gz;
        keep = a.w > 0.f && !(G >= r2max);
      }
      const unsigned mask = __ballot_sync(FULL, keep);
      if (keep) list[len + __popc(mask & below)] = (unsigned short)k;
      len += __popc(mask);
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const int k = list[j];
      const float4 a = s_a[k], b = s_b[k];
      const float2 c = s_c[k];
      const float dx = qx - a.x;
      const float dy = qy - a.y;
      const float dz = qz - a.z;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < r2) {
        const float w = fabsf(nx * b.x + ny * b.y + nz * b.z);
        sr += w * b.w;
        sg += w * c.x;
        sb += w * c.y;
        m += 1.f;
      }
    }
  }
  if (q < n) {
    out[q] = sr;
    out[n + q] = sg;
    out[2 * n + q] = sb;
    out[3 * n + q] = m;
  }
}

extern "C" int dense_gather(const void* qp, const void* qr2, const void* qns,
                            const void* pp, const void* pal, const void* pwi,
                            const void* pval, int n, int p,
                            const void* n_valid, void* out, void* stream) {
  if (n > 0) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    dense_gather_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)qp, (const float*)qr2, (const float*)qns,
        (const float*)pp, (const float*)pal, (const float*)pwi,
        (const unsigned char*)pval, n, p, (const int*)n_valid, (float*)out);
  }
  return (int)cudaGetLastError();
}
