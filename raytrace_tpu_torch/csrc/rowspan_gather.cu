// Row-span photon gather: one block per 128-query tile, one thread per query.
//
// Replaces: raytrace_tpu/ops/pallas_gather.py `_rowspan_kernel` (launched by
// `_rowspan_S_impl` from `gather_radius_pallas_rowspan`). There a sequential
// grid walks a tile-major (tile, chunk) job list; a tile's [4, 128] output
// block is zeroed on its first job and accumulated across the following
// ones, per job S_rgb += sum_{dist2 < r2, valid} |n_s . wi| * alpha and
// M += count.
//
// Bound on the H100: pair-test compute, n_jobs x 128 x 512 distance tests
// (about 20 fp32 ops each); each job reads one 512-photon chunk (20 KB) and
// reuses it 128 times, far above the card's bytes-per-flop line.
//
// Design: Hopper runs blocks in parallel and in no order, so nothing may
// carry between blocks. Each block owns one query tile and walks its own
// contiguous range [tile_begin, tile_end) of the tile-major job list (the
// prep computes the ranges, already cut at the job capacity). Per job the
// block stages the chunk's rows (px py pz wx wy wz valid ax ay az) in
// shared memory; every thread then scans all 512 photons against its own
// query, reading each shared word as a broadcast. Sums run in a fixed
// order with no atomics, so results are reproducible run to run. A tile
// with no jobs writes zeros. Capacity truncation and the tile_ok masking
// stay in the PyTorch prep, exactly as in the TPU path. The library is
// built with --fmad=false, so dist2 and each term |n_s . wi| * alpha round
// as in the plain PyTorch version: the two agree on every photon count and
// differ only by the order of the sums.
#include <cuda_runtime.h>

#define TILE_Q 128
#define ROWS 16  // photon rows per chunk: px py pz wx wy wz valid pad ax ay az pad*5

__global__ void rowspan_kernel(
    const int* __restrict__ pid, const int* __restrict__ tile_begin,
    const int* __restrict__ tile_end, int n_chunks, int chunk,
    const float* __restrict__ qpT, const float* __restrict__ qr2,
    const float* __restrict__ qnsT, const float* __restrict__ pdata, int nq,
    float* __restrict__ out) {
  extern __shared__ float s[];  // [10][chunk]
  const int tile = blockIdx.x;
  const int q = tile * TILE_Q + threadIdx.x;  // nq is a multiple of TILE_Q
  const float qx = qpT[q], qy = qpT[nq + q], qz = qpT[2 * nq + q];
  const float r2 = qr2[q];
  const float nx = qnsT[q], ny = qnsT[nq + q], nz = qnsT[2 * nq + q];
  float sr = 0.f, sg = 0.f, sb = 0.f, m = 0.f;

  const int j_end = tile_end[tile];
  for (int j = tile_begin[tile]; j < j_end; ++j) {
    const float* blk = pdata + (size_t)(pid[j] % n_chunks) * ROWS * chunk;
    __syncthreads();
    for (int k = threadIdx.x; k < chunk; k += TILE_Q) {
      for (int r = 0; r < 7; ++r) s[r * chunk + k] = blk[r * chunk + k];
      for (int r = 0; r < 3; ++r)
        s[(7 + r) * chunk + k] = blk[(8 + r) * chunk + k];
    }
    __syncthreads();
    for (int k = 0; k < chunk; ++k) {
      const float dx = qx - s[k];
      const float dy = qy - s[chunk + k];
      const float dz = qz - s[2 * chunk + k];
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < r2 && s[6 * chunk + k] > 0.f) {
        const float w = fabsf(nx * s[3 * chunk + k] + ny * s[4 * chunk + k] +
                              nz * s[5 * chunk + k]);
        sr += w * s[7 * chunk + k];
        sg += w * s[8 * chunk + k];
        sb += w * s[9 * chunk + k];
        m += 1.f;
      }
    }
  }
  out[q] = sr;
  out[nq + q] = sg;
  out[2 * nq + q] = sb;
  out[3 * nq + q] = m;
}

extern "C" int rowspan_gather(const void* pid, const void* tile_begin,
                              const void* tile_end, int n_tiles, int n_chunks,
                              int chunk, const void* qpT, const void* qr2,
                              const void* qnsT, const void* pdata, void* out,
                              void* stream) {
  // the wrapper keeps chunk <= 1024: at most 40 KB, under the 48 KB that
  // dynamic shared memory gets without an opt-in
  const size_t smem = (size_t)10 * chunk * sizeof(float);
  if (n_tiles > 0) {
    rowspan_kernel<<<n_tiles, TILE_Q, smem, (cudaStream_t)stream>>>(
        (const int*)pid, (const int*)tile_begin, (const int*)tile_end,
        n_chunks, chunk, (const float*)qpT, (const float*)qr2,
        (const float*)qnsT, (const float*)pdata, n_tiles * TILE_Q,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
