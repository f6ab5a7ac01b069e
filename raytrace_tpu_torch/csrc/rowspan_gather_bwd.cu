// Row-span photon gather, backward in alpha: one block per photon chunk, one
// thread per photon.
//
// Replaces: raytrace_tpu/ops/pallas_gather.py `_rowspan_bwd_kernel` (launched
// by `_rowspan_S_bwd`, the custom VJP of `_rowspan_S`). The forward sum
// S[q] = sum_{dist2 < r2, valid} |n_s . wi_p| * alpha_p is linear in alpha
// with weights that depend only on geometry, so its transpose is
// dalpha_p = sum_q w_qp * cot_q over the same jobs. There a sequential grid
// walks the job list sorted chunk-major and carries each chunk's [8, chunk]
// output block across consecutive grid steps; chunks no job touches are
// zeroed afterwards.
//
// Bound on the H100: pair tests, exactly as in the forward kernel K2 (the
// same n_jobs x 128 x chunk distance tests, 8.6e8 per frame at the headline;
// each job reads one 128-query tile, 5 KB, and reuses it chunk times).
//
// Design: Hopper runs blocks in parallel and in no order, so nothing may
// carry between blocks. The prep (ops/rowspan_gather.py `chunk_major`) sorts
// the valid jobs by (chunk, tile) and gives each chunk its contiguous job
// range, so one block owns one chunk and walks its own range. Each thread
// keeps its photon's geometry and its dalpha sums in registers; per job the
// block stages the tile's q, r2, n_s and cotangent rows (10 x 128 floats) in
// shared memory, and every thread scans the 128 queries in index order,
// reading each shared word as a broadcast. No atomics and a fixed order, so
// results repeat run to run; a chunk without jobs writes zeros. Row 3 counts
// each photon's terms (the pairs within radius), which bounds the rounding
// against the plain version. Built with --fmad=false, so dist2 and each term
// |n_s . wi| * cot round as in the plain PyTorch version and in K2: the two
// agree on every pair and differ only by the order of the sums.
#include <cuda_runtime.h>

#define TILE_Q 128
#define ROWS 16  // photon rows per chunk: px py pz wx wy wz valid pad ax ay az pad*5

__global__ void rowspan_bwd_kernel(
    const int* __restrict__ pid, const int* __restrict__ chunk_begin,
    const int* __restrict__ chunk_end, int n_chunks, int chunk,
    const float* __restrict__ qpT, const float* __restrict__ qr2,
    const float* __restrict__ qnsT, const float* __restrict__ cotT,
    const float* __restrict__ pdata, int nq, float* __restrict__ dout) {
  __shared__ float s[10][TILE_Q];  // qx qy qz r2 nx ny nz cot_r cot_g cot_b
  const int c = blockIdx.x;
  const int k = threadIdx.x;  // blockDim.x == chunk
  const float* blk = pdata + (size_t)c * ROWS * chunk;
  const float px = blk[k], py = blk[chunk + k], pz = blk[2 * chunk + k];
  const float wx = blk[3 * chunk + k], wy = blk[4 * chunk + k],
              wz = blk[5 * chunk + k];
  const bool valid = blk[6 * chunk + k] > 0.f;
  float dr = 0.f, dg = 0.f, db = 0.f, terms = 0.f;

  const int j_end = chunk_end[c];
  for (int j = chunk_begin[c]; j < j_end; ++j) {
    const int q0 = (pid[j] / n_chunks) * TILE_Q;
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_Q; i += blockDim.x) {
      const int q = q0 + i;
      s[0][i] = qpT[q];
      s[1][i] = qpT[nq + q];
      s[2][i] = qpT[2 * nq + q];
      s[3][i] = qr2[q];
      s[4][i] = qnsT[q];
      s[5][i] = qnsT[nq + q];
      s[6][i] = qnsT[2 * nq + q];
      s[7][i] = cotT[q];
      s[8][i] = cotT[nq + q];
      s[9][i] = cotT[2 * nq + q];
    }
    __syncthreads();
    if (!valid) continue;
    for (int i = 0; i < TILE_Q; ++i) {
      const float dx = s[0][i] - px;
      const float dy = s[1][i] - py;
      const float dz = s[2][i] - pz;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < s[3][i]) {
        const float w = fabsf(s[4][i] * wx + s[5][i] * wy + s[6][i] * wz);
        dr += w * s[7][i];
        dg += w * s[8][i];
        db += w * s[9][i];
        terms += 1.f;
      }
    }
  }
  float* out = dout + (size_t)c * 4 * chunk;
  out[k] = dr;
  out[chunk + k] = dg;
  out[2 * chunk + k] = db;
  out[3 * chunk + k] = terms;
}

extern "C" int rowspan_gather_bwd(const void* pid, const void* chunk_begin,
                                  const void* chunk_end, int n_chunks,
                                  int n_tiles, int chunk, const void* qpT,
                                  const void* qr2, const void* qnsT,
                                  const void* cotT, const void* pdata,
                                  void* dout, void* stream) {
  // the wrapper keeps 0 < chunk <= 1024, the largest block Hopper runs
  if (n_chunks > 0) {
    rowspan_bwd_kernel<<<n_chunks, chunk, 0, (cudaStream_t)stream>>>(
        (const int*)pid, (const int*)chunk_begin, (const int*)chunk_end,
        n_chunks, chunk, (const float*)qpT, (const float*)qr2,
        (const float*)qnsT, (const float*)cotT, (const float*)pdata,
        n_tiles * TILE_Q, (float*)dout);
  }
  return (int)cudaGetLastError();
}
