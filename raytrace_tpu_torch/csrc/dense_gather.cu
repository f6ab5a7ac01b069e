// Dense small-map photon gather: one thread per query over the whole valid
// prefix of a compacted photon map.
//
// Replaces: raytrace_tpu/ops/pallas_gather.py `_kernel` (launched by
// `gather_radius_pallas`). There a (query tile, photon chunk) grid forms
// dense [128, tile_p] blocks, skips chunks past the scalar-prefetched valid
// count, and accumulates per query L += kd * sum_{dist2 < r2, valid}
// |n_s . wi| * alpha and M += count in VMEM across the chunk axis.
//
// Bound on the H100: fp32 instruction throughput. Each (query, photon) pair
// costs 10 fp32 operations for the radius test and 13 more inside the
// radius, while the inputs are a few MB (a 2^14-slot map is 640 KB, 262,144
// queries 7 MB): far above the card's bytes-per-flop line. Shared-memory staging serves
// that: a block reads each photon's 10 floats from device memory once per
// chunk and every thread reads the staged word as a broadcast, so the inner
// loop runs arithmetic and shared loads only.
//
// Design: each block of 256 threads owns 256 queries and keeps their
// position, radius and normal in registers. It walks the valid prefix
// [0, n_valid) in chunks of 512 photons, staging px py pz wx wy wz valid ax
// ay az (20 KB) in shared memory, and every thread scans the chunk in index
// order, keeping S and M in registers. n_valid is read from device memory,
// so the caller never waits for it (the TPU kernel's scalar prefetch). No
// atomics and a fixed order: the result is the same in every run. The
// library is built with --fmad=false, so dist2 and each term
// |n_s . wi| * alpha round as in the plain PyTorch version; the two agree on
// every count M and differ only by the order of the sums. kd/pi multiplies
// once, outside, on the sums (the TPU kernel multiplied per chunk).
#include <cuda_runtime.h>

#define BLOCK 256
#define CHUNK 512

__global__ void dense_gather_kernel(
    const float* __restrict__ qp, const float* __restrict__ qr2,
    const float* __restrict__ qns, const float* __restrict__ pp,
    const float* __restrict__ pal, const float* __restrict__ pwi,
    const unsigned char* __restrict__ pval, int n, int p,
    const int* __restrict__ n_valid, float* __restrict__ out) {
  __shared__ float s[10][CHUNK];
  const int q = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = q < n;
  float qx = 0.f, qy = 0.f, qz = 0.f, r2 = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (live) {
    qx = qp[3 * q]; qy = qp[3 * q + 1]; qz = qp[3 * q + 2];
    r2 = qr2[q];
    nx = qns[3 * q]; ny = qns[3 * q + 1]; nz = qns[3 * q + 2];
  }
  float sr = 0.f, sg = 0.f, sb = 0.f, m = 0.f;

  const int nv = min(*n_valid, p);
  for (int base = 0; base < nv; base += CHUNK) {
    const int cnt = min(CHUNK, nv - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += BLOCK) {
      const int g = 3 * (base + k);
      for (int c = 0; c < 3; ++c) {
        s[c][k] = pp[g + c];
        s[3 + c][k] = pwi[g + c];
        s[7 + c][k] = pal[g + c];
      }
      s[6][k] = pval[base + k] ? 1.f : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < cnt; ++k) {
      const float dx = qx - s[0][k];
      const float dy = qy - s[1][k];
      const float dz = qz - s[2][k];
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < r2 && s[6][k] > 0.f) {
        const float w = fabsf(nx * s[3][k] + ny * s[4][k] + nz * s[5][k]);
        sr += w * s[7][k];
        sg += w * s[8][k];
        sb += w * s[9][k];
        m += 1.f;
      }
    }
  }
  if (live) {
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
