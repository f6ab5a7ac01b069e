// Row-span photon gather: each query tile's job range cut into work items of
// at most ITEM_JOBS jobs, one block per item, one thread per query; the
// items' partial sums added per tile in item order.
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
// carry between blocks. The prep computes each tile's contiguous range
// [tile_begin, tile_end) of the tile-major job list, already cut at the job
// capacity. Those ranges are far from even: at the headline the heaviest
// tile holds 281 jobs against a mean of 6.4, so one block per tile waits on
// a few tiles' serial walks. So the wrapper cuts each range into work items
// of at most ITEM_JOBS consecutive jobs (ops/work_items.py: cumsum and
// searchsorted on the device, no host sync) and each block walks one item.
// Per job the block stages the chunk in shared memory as 128-bit rows,
// (px py pz valid) and (wx wy wz ax), and a 64-bit row (ay az); every thread
// then scans the chunk's photons in index order against its own query: the
// radius test reads one broadcast 128-bit word, the weight and flux the
// other two only for a photon inside the radius.
//
// The sum across items is fixed in order, with no float atomics: a tile of
// one item writes its four rows; otherwise each item writes its partial
// [4, 128] rows to scratch, and the last of the tile's blocks to finish (a
// per-tile counter behind a __threadfence) adds the tile's partials in item
// order. So results repeat bit for bit run to run, whichever block finishes
// last. A tile without jobs has no item and keeps the zeros the wrapper
// wrote. Capacity truncation and the tile_ok masking stay in the PyTorch
// prep, exactly as in the TPU path. The library is built with --fmad=false,
// so dist2 and each term |n_s . wi| * alpha round as in the plain PyTorch
// version: the two agree on every photon count and differ only by the order
// of the sums (for nonnegative terms by at most 2 * M * 2^-24 of S).
#include <cuda_runtime.h>

#define TILE_Q 128
#define ROWS 16  // photon rows per chunk: px py pz wx wy wz valid pad ax ay az pad*5
// J: jobs per work item. The heaviest headline tile's 281 jobs make 36
// items. On the headline list J = 8 is the fastest of 8-64 (10% under 16,
// 31% under 32), and one item per tile is 6.6x slower (utils/sweep.py,
// PERF.md); the scratch is 2 KB a slot, n_tiles + capacity / J slots
#define ITEM_JOBS 8

__global__ void __launch_bounds__(TILE_Q) rowspan_kernel(
    const int* __restrict__ pid, const int* __restrict__ item_tile,
    const int* __restrict__ item_lo, const int* __restrict__ item_hi,
    const int* __restrict__ tile_first, const int* __restrict__ tile_items,
    int* __restrict__ done, int n_chunks, int chunk,
    const float* __restrict__ qpT, const float* __restrict__ qr2,
    const float* __restrict__ qnsT, const float* __restrict__ pdata, int nq,
    float* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ float4 s_p[];  // [chunk] px py pz valid
  float4* s_w = s_p + chunk;                              // [chunk] wx wy wz ax
  float2* s_a = reinterpret_cast<float2*>(s_w + chunk);  // [chunk] ay az
  __shared__ bool s_last;
  const int item = blockIdx.x;
  const int tile = item_tile[item];
  if (tile < 0) return;  // a slot past the last item: block-uniform

  const int i = threadIdx.x;
  const int q = tile * TILE_Q + i;  // nq is a multiple of TILE_Q
  const float qx = qpT[q], qy = qpT[nq + q], qz = qpT[2 * nq + q];
  const float r2 = qr2[q];
  const float nx = qnsT[q], ny = qnsT[nq + q], nz = qnsT[2 * nq + q];
  float sr = 0.f, sg = 0.f, sb = 0.f, m = 0.f;

  const int j_end = item_hi[item];
  for (int j = item_lo[item]; j < j_end; ++j) {
    const float* blk = pdata + (size_t)(pid[j] % n_chunks) * ROWS * chunk;
    __syncthreads();
    for (int k = i; k < chunk; k += TILE_Q) {
      s_p[k] = make_float4(blk[k], blk[chunk + k], blk[2 * chunk + k],
                           blk[6 * chunk + k]);
      s_w[k] = make_float4(blk[3 * chunk + k], blk[4 * chunk + k],
                           blk[5 * chunk + k], blk[8 * chunk + k]);
      s_a[k] = make_float2(blk[9 * chunk + k], blk[10 * chunk + k]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < chunk; ++k) {
      const float4 p = s_p[k];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (dist2 < r2 && p.w > 0.f) {
        const float4 w = s_w[k];
        const float2 a = s_a[k];
        const float wt = fabsf(nx * w.x + ny * w.y + nz * w.z);
        sr += wt * w.w;
        sg += wt * a.x;
        sb += wt * a.y;
        m += 1.f;
      }
    }
  }

  const int n_items = tile_items[tile];
  if (n_items == 1) {  // block-uniform
    out[q] = sr;
    out[nq + q] = sg;
    out[2 * nq + q] = sb;
    out[3 * nq + q] = m;
    return;
  }
  float* mine = partial + (size_t)item * 4 * TILE_Q;
  mine[i] = sr;
  mine[TILE_Q + i] = sg;
  mine[2 * TILE_Q + i] = sb;
  mine[3 * TILE_Q + i] = m;

  // the last of the tile's items to finish adds their partials in item
  // order: each block's stores are made visible device-wide before its
  // count, so the block that counts last sees every partial
  __threadfence();
  __syncthreads();
  if (i == 0) s_last = atomicAdd(done + tile, 1) == n_items - 1;
  __syncthreads();
  if (!s_last) return;
  const float* first = partial + (size_t)tile_first[tile] * 4 * TILE_Q;
  for (int r = 0; r < 4; ++r) {
    const int e = r * TILE_Q + i;
    float s = __ldcg(first + e);
    for (int k = 1; k < n_items; ++k)
      s += __ldcg(first + (size_t)k * 4 * TILE_Q + e);
    out[(size_t)r * nq + q] = s;
  }
}

extern "C" int rowspan_gather_item_jobs() { return ITEM_JOBS; }

extern "C" int rowspan_gather(
    const void* pid, const void* item_tile, const void* item_lo,
    const void* item_hi, int n_slots, const void* tile_first,
    const void* tile_items, void* done, int n_tiles, int n_chunks, int chunk,
    const void* qpT, const void* qr2, const void* qnsT, const void* pdata,
    void* partial, void* out, void* stream) {
  // the wrapper keeps 0 < chunk <= 1024: at most 40 KB of staged rows, under
  // the 48 KB that dynamic shared memory gets without an opt-in
  const size_t smem = (size_t)chunk * (2 * sizeof(float4) + sizeof(float2));
  if (n_slots > 0) {
    rowspan_kernel<<<n_slots, TILE_Q, smem, (cudaStream_t)stream>>>(
        (const int*)pid, (const int*)item_tile, (const int*)item_lo,
        (const int*)item_hi, (const int*)tile_first, (const int*)tile_items,
        (int*)done, n_chunks, chunk, (const float*)qpT, (const float*)qr2,
        (const float*)qnsT, (const float*)pdata, n_tiles * TILE_Q,
        (float*)partial, (float*)out);
  }
  return (int)cudaGetLastError();
}
