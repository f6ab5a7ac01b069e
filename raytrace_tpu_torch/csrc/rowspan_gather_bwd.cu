// Row-span photon gather, backward in alpha: the jobs of each photon chunk
// split into work items of at most ITEM_JOBS jobs, one block per item, one
// thread per photon; the items' partial sums added per chunk in item order.
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
// range. Those ranges are far from even: the prep gives every query tile a
// synthetic span on chunk 0, so at the headline chunk 0 holds one job per
// tile (2,048) against a mean of 47 over the chunks with jobs, and one block
// per chunk waits on chunk 0's serial walk. So the wrapper cuts each range
// into work items of at most ITEM_JOBS consecutive jobs (`work_items`:
// cumsum and searchsorted on the device, no host sync) and each block walks
// one item. Inside an item each thread keeps its photon's geometry and its
// dalpha sums in registers; per job the block stages the tile's q and r2,
// n_s and the cotangent (10 x 128 floats) in shared memory as float4 rows,
// and every thread scans the 128 queries in index order, reading each staged
// query as a broadcast (one 128-bit load for the radius test).
//
// The sum across items is fixed in order, with no float atomics: a chunk of
// one item writes its sums; otherwise each item writes its partial [4, chunk]
// rows to scratch, and the last of the chunk's blocks to finish (a per-chunk
// counter behind a __threadfence) adds the chunk's partials in item order.
// So results repeat bit for bit run to run, whichever block finishes last. A
// chunk without jobs has no item and keeps the zeros the wrapper wrote. Row 3
// counts each photon's terms (the pairs within radius, exact in float), which
// bounds the rounding against the plain version. Built with --fmad=false, so
// dist2 and each term |n_s . wi| * cot round as in the plain PyTorch version
// and in K2: the two agree on every pair and differ only by the order of the
// sums (for nonnegative terms by at most 2 * terms * 2^-24 of dalpha).
#include <cuda_runtime.h>

#define TILE_Q 128
#define ROWS 16  // photon rows per chunk: px py pz wx wy wz valid pad ax ay az pad*5
// J: jobs per work item. Chunk 0's 2,048 jobs make 128 items. On the
// headline list J = 16 and 8 tie as the fastest of 8-64, and one item per
// chunk is 19x slower (utils/sweep.py, PERF.md); two photons a thread, each
// staged query serving two tests, measured slower than one
#define ITEM_JOBS 16

__global__ void rowspan_bwd_kernel(
    const int* __restrict__ pid, const int* __restrict__ item_chunk,
    const int* __restrict__ item_lo, const int* __restrict__ item_hi,
    const int* __restrict__ chunk_first, const int* __restrict__ chunk_items,
    int* __restrict__ done, int n_chunks, int chunk,
    const float* __restrict__ qpT, const float* __restrict__ qr2,
    const float* __restrict__ qnsT, const float* __restrict__ cotT,
    const float* __restrict__ pdata, int nq, float* __restrict__ partial,
    float* __restrict__ dout) {
  __shared__ float4 s_q[TILE_Q];  // qx qy qz r2
  __shared__ float4 s_n[TILE_Q];  // nx ny nz cot_r
  __shared__ float2 s_c[TILE_Q];  // cot_g cot_b
  __shared__ bool s_last;
  const int item = blockIdx.x;
  const int c = item_chunk[item];
  if (c < 0) return;  // a slot past the last item: block-uniform

  const int k = threadIdx.x;  // blockDim.x == chunk
  const float* blk = pdata + (size_t)c * ROWS * chunk;
  const float px = blk[k], py = blk[chunk + k], pz = blk[2 * chunk + k];
  const float wx = blk[3 * chunk + k], wy = blk[4 * chunk + k],
              wz = blk[5 * chunk + k];
  const bool valid = blk[6 * chunk + k] > 0.f;
  float dr = 0.f, dg = 0.f, db = 0.f, terms = 0.f;

  const int j_end = item_hi[item];
  for (int j = item_lo[item]; j < j_end; ++j) {
    const int q0 = (pid[j] / n_chunks) * TILE_Q;
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_Q; i += blockDim.x) {
      const int q = q0 + i;
      s_q[i] = make_float4(qpT[q], qpT[nq + q], qpT[2 * nq + q], qr2[q]);
      s_n[i] = make_float4(qnsT[q], qnsT[nq + q], qnsT[2 * nq + q], cotT[q]);
      s_c[i] = make_float2(cotT[nq + q], cotT[2 * nq + q]);
    }
    __syncthreads();
    if (!valid) continue;
#pragma unroll 4
    for (int i = 0; i < TILE_Q; ++i) {
      const float4 q = s_q[i];
      const float dx = q.x - px;
      const float dy = q.y - py;
      const float dz = q.z - pz;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < q.w) {
        const float4 n = s_n[i];
        const float2 cgb = s_c[i];
        const float w = fabsf(n.x * wx + n.y * wy + n.z * wz);
        dr += w * n.w;
        dg += w * cgb.x;
        db += w * cgb.y;
        terms += 1.f;
      }
    }
  }

  const int n_items = chunk_items[c];
  float* out = (n_items == 1 ? dout + (size_t)c * 4 * chunk
                             : partial + (size_t)item * 4 * chunk);
  out[k] = dr;
  out[chunk + k] = dg;
  out[2 * chunk + k] = db;
  out[3 * chunk + k] = terms;
  if (n_items == 1) return;  // block-uniform

  // the last of the chunk's items to finish adds their partials in item
  // order: each block's stores are made visible device-wide before its
  // count, so the block that counts last sees every partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + c, 1) == n_items - 1;
  __syncthreads();
  if (!s_last) return;
  const float* first = partial + (size_t)chunk_first[c] * 4 * chunk;
  float* sum = dout + (size_t)c * 4 * chunk;
  for (int e = threadIdx.x; e < 4 * chunk; e += blockDim.x) {
    float s = __ldcg(first + e);
    for (int m = 1; m < n_items; ++m) s += __ldcg(first + (size_t)m * 4 * chunk + e);
    sum[e] = s;
  }
}

extern "C" int rowspan_gather_bwd_item_jobs() { return ITEM_JOBS; }

extern "C" int rowspan_gather_bwd(
    const void* pid, const void* item_chunk, const void* item_lo,
    const void* item_hi, int n_slots, const void* chunk_first,
    const void* chunk_items, void* done, int n_chunks, int n_tiles,
    int chunk, const void* qpT, const void* qr2, const void* qnsT,
    const void* cotT, const void* pdata, void* partial, void* dout,
    void* stream) {
  // the wrapper keeps 0 < chunk <= 1024, the largest block Hopper runs
  if (n_slots > 0) {
    rowspan_bwd_kernel<<<n_slots, chunk, 0, (cudaStream_t)stream>>>(
        (const int*)pid, (const int*)item_chunk, (const int*)item_lo,
        (const int*)item_hi, (const int*)chunk_first,
        (const int*)chunk_items, (int*)done, n_chunks, chunk,
        (const float*)qpT, (const float*)qr2, (const float*)qnsT,
        (const float*)cotT, (const float*)pdata, n_tiles * TILE_Q,
        (float*)partial, (float*)dout);
  }
  return (int)cudaGetLastError();
}
