// Morton-span photon gather: each query tile's chunk span cut into work items
// of at most ITEM_CHUNKS chunks, one block per item, one thread per query;
// each warp's photons pre-culled against the warp's query box, chunks that
// no warp of the tile reaches never staged; the items' partial sums added
// per tile in item order.
//
// Replaces: raytrace_tpu/ops/pallas_gather.py `_grid_kernel` (launched by
// `gather_radius_pallas_grid`). There each grid step owns one Morton-sorted
// query tile, double-buffers the photon chunks [lo_chunk, lo_chunk + nc)
// HBM -> VMEM with async copies, and accumulates per query
// S = sum_{dist2 < r2, valid} |n_s . wi| * alpha and the count M as [128,
// chunk] blocks.
//
// Bound on the H100: the pair tests, 10 fp32 operations each and 13 more
// inside the radius, on data that is read once (the queries, 11 MB at
// 262,144 of them, and the chunks some span touches). The Morton corner
// span [morton(c - 1), morton(c + 1)] over-covers the tile's neighbourhood
// near octant boundaries and the cell is pinned to the largest live radius,
// so of a span's pairs about 0.4% count (the JAX note on this kernel). The
// design drops the rest before the test, exactly, as K4 does
// (csrc/dense_gather.cu):
//
// - Each warp takes the box of its queries with r2 > 0 and their largest
//   r2, with NaN-ignoring min and max. For a box B and a point or box P the
//   per-axis gap is g = fl(P.lo - B.hi) where P.lo > B.hi, fl(B.lo - P.hi)
//   where P.hi < B.lo, else 0, and G = fl(fl(fl(gx²) + fl(gy²)) + fl(gz²)).
//   Rounding to nearest is monotone, so dist2 >= G for every query of the
//   warp and every photon of P: where G >= r2max no pair can count.
// - Chunk skip: the wrapper gives each chunk's box over its valid photons
//   (NaN coordinates propagate, and a NaN gap keeps the chunk; an empty
//   chunk's box is inverted and its gap infinite). Lane k of each warp
//   tests chunk k of the item against the warp's box; the block stages
//   only the chunks that some warp reaches, and a warp scans only those it
//   reaches. A chunk box holds each of its photons, so a skipped chunk's
//   photons would all fail the photon test below.
// - Photon cull: per staged photon G against the warp's box, 32 photons a
//   step, one per lane; survivors (valid, G not >= r2max, a NaN G kept) go
//   into the warp's list in shared memory in index order (`__ballot_sync`,
//   `__popc`), and every lane tests the list only.
//
// Staging: each chunk an item keeps is loaded into 128-bit rows, (px py pz
// valid) and (wx wy wz ax), and a 64-bit row (ay az): the cull and the
// radius test read one 16-byte word a photon, the weight and flux only
// inside the radius. pdata keeps its layout of ten 4-byte rows a chunk (the
// plain version and the prep's tests read it), so each word is loaded as 4
// bytes, coalesced on the global side. One buffer, plain loads: with
// items of 1-2 chunks a second buffer, filled by cp.async during the scan,
// overlapped little and halved the blocks an SM holds (0.0896 against
// 0.0809 ms at J = 2), and cp.async into one buffer, which overlaps
// nothing, took 0.081 ms against the plain loads' 0.074 (PERF.md).
//
// Uneven spans: spans run from 1 to ~60 chunks (5.2 on average at phase
// k5's inputs), so one block per tile waited on a few long serial walks.
// The wrapper cuts each tile's range into work items of at most
// ITEM_CHUNKS chunks (ops/work_items.py) and each block walks one item. A
// tile of one item writes its four rows; otherwise each item writes its
// partial [4, 128] rows to scratch and the last of the tile's blocks to
// finish (a per-tile counter behind a __threadfence) adds them in item
// order, as K2 does. No float atomics: results repeat bit for bit. A tile
// with an empty span has no item and keeps the zeros the wrapper wrote.
//
// Per (item, query) the sums run over the same terms in the same order
// (chunk, then photon index) as a test of every pair, so the output does
// not depend on the cull. The library is built with --fmad=false: dist2,
// G and each term |n_s . wi| * alpha round as in the plain PyTorch
// version, so the two agree on every count M and differ only by the order
// of the sums. kd/pi multiplies outside, on the sums.
#include <cuda_runtime.h>

#define TILE_Q 128
#define WARPS (TILE_Q / 32)
#define FULL 0xffffffffu
// J: chunks per work item. At phase k5's inputs the heaviest warps keep up
// to ~5,000 photons over their tile's span and test them serially, so the
// shortest items are the fastest: J = 1 and 2 take the same time, 4 is 26%
// slower, 8 78%, one item per tile 2.9x (utils/sweep.py, PERF.md). J = 2
// needs half J = 1's blocks and scratch (2 KB a slot, n_tiles + sum nc / J
// slots)
#define ITEM_CHUNKS 2

// the warp's box, the gap G and the survivor list are K4's
// (csrc/dense_gather.cu): a change to their exactness argument is made in
// both kernels and in dense_gather.py's `group_box` and `gap2`
__device__ __forceinline__ float gap(float p, float lo, float hi) {
  return p < lo ? lo - p : (p > hi ? p - hi : 0.f);
}

// the gap between the box [plo, phi] and [lo, hi] on one axis
__device__ __forceinline__ float box_gap(float plo, float phi, float lo,
                                         float hi) {
  return phi < lo ? lo - phi : (plo > hi ? plo - hi : 0.f);
}

// one chunk's ten rows (px py pz wx wy wz valid ax ay az) into the 128-bit
// rows a = (px py pz valid), b = (wx wy wz ax) and c = (ay az)
__device__ __forceinline__ void stage_chunk(const float* __restrict__ blk,
                                            int chunk, float4* a, float4* b,
                                            float2* c) {
  for (int k = threadIdx.x; k < chunk; k += TILE_Q) {
    a[k] = make_float4(blk[k], blk[chunk + k], blk[2 * chunk + k],
                       blk[6 * chunk + k]);
    b[k] = make_float4(blk[3 * chunk + k], blk[4 * chunk + k],
                       blk[5 * chunk + k], blk[7 * chunk + k]);
    c[k] = make_float2(blk[8 * chunk + k], blk[9 * chunk + k]);
  }
}

// at least 6 blocks an SM: 80 registers a thread at most (168 unbounded),
// no spills; 3-8 blocks took the same time
__global__ void __launch_bounds__(TILE_Q, 6) grid_gather_kernel(
    const int* __restrict__ item_tile, const int* __restrict__ item_lo,
    const int* __restrict__ item_hi, const int* __restrict__ tile_first,
    const int* __restrict__ tile_items, int* __restrict__ done, int chunk,
    const float* __restrict__ qpT, const float* __restrict__ qr2,
    const float* __restrict__ qnsT, const float* __restrict__ pdata,
    const float* __restrict__ cbox, int nq, float* __restrict__ partial,
    float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* s_a = smem;                                   // [chunk]
  float4* s_b = s_a + chunk;                            // [chunk]
  float2* s_c = reinterpret_cast<float2*>(s_b + chunk);  // [chunk]
  unsigned short* s_list =                              // [WARPS][chunk]
      reinterpret_cast<unsigned short*>(s_c + chunk);
  __shared__ unsigned s_reach[WARPS];
  __shared__ bool s_last;

  const int item = blockIdx.x;
  const int tile = item_tile[item];
  if (tile < 0) return;  // a slot past the last item: block-uniform

  const int i = threadIdx.x, warp = i >> 5, lane = i & 31;
  const int q = tile * TILE_Q + i;  // nq is a multiple of TILE_Q
  const float qx = qpT[q], qy = qpT[nq + q], qz = qpT[2 * nq + q];
  const float r2 = qr2[q];
  const float nx = qnsT[q], ny = qnsT[nq + q], nz = qnsT[2 * nq + q];

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
  unsigned short* list = s_list + warp * chunk;

  float sr = 0.f, sg = 0.f, sb = 0.f, m = 0.f;
  const int c_end = item_hi[item];
  for (int g0 = item_lo[item]; g0 < c_end; g0 += 32) {
    // the chunks g0 + k, k < 32, that this warp reaches
    bool reach = false;
    if (any && g0 + lane < c_end) {
      const float* bx = cbox + 6 * (g0 + lane);
      const float gx = box_gap(bx[0], bx[3], lox, hix);
      const float gy = box_gap(bx[1], bx[4], loy, hiy);
      const float gz = box_gap(bx[2], bx[5], loz, hiz);
      reach = !(gx * gx + gy * gy + gz * gz >= r2max);
    }
    const unsigned mine = __ballot_sync(FULL, reach);
    if (lane == 0) s_reach[warp] = mine;
    __syncthreads();
    unsigned todo = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) todo |= s_reach[w];
    __syncthreads();  // s_reach is rewritten by the next group

    while (todo) {  // block-uniform
      const int cur = __ffs(todo) - 1;
      todo &= todo - 1u;
      stage_chunk(pdata + (size_t)(g0 + cur) * 10 * chunk, chunk, s_a, s_b,
                  s_c);
      __syncthreads();
      if ((mine >> cur) & 1u) {  // warp-uniform
        int len = 0;
#pragma unroll 4
        for (int k0 = 0; k0 < chunk; k0 += 32) {
          const int k = k0 + lane;
          bool keep = false;
          if (k < chunk) {
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
        // the weight only where some lane is inside, and there without a
        // branch: a pair outside the radius adds +0, which leaves each sum
        // as it was (a sum that starts at +0 is never -0)
#pragma unroll 4
        for (int j = 0; j < len; ++j) {
          const int k = list[j];
          const float4 a = s_a[k], b = s_b[k];
          const float2 c = s_c[k];
          const float dx = qx - a.x;
          const float dy = qy - a.y;
          const float dz = qz - a.z;
          const bool in = dx * dx + dy * dy + dz * dz < r2;
          if (__any_sync(FULL, in)) {
            const float w = fabsf(nx * b.x + ny * b.y + nz * b.z);
            sr += in ? w * b.w : 0.f;
            sg += in ? w * c.x : 0.f;
            sb += in ? w * c.y : 0.f;
            m += in ? 1.f : 0.f;
          }
        }
      }
      __syncthreads();  // every warp is done with the staged chunk
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
  float* part = partial + (size_t)item * 4 * TILE_Q;
  part[i] = sr;
  part[TILE_Q + i] = sg;
  part[2 * TILE_Q + i] = sb;
  part[3 * TILE_Q + i] = m;

  // the last of the tile's items to finish adds their partials in item
  // order: each block's stores are made visible device-wide before its
  // count, so the block that counts last sees every partial
  __threadfence();
  __syncthreads();
  if (i == 0) s_last = atomicAdd(done + tile, 1) == n_items - 1;
  __syncthreads();
  if (!s_last) return;
  // the four rows of every partial are loaded before they are added, so
  // the loads of several items are in flight together
  const float* first = partial + (size_t)tile_first[tile] * 4 * TILE_Q + i;
  float s0 = __ldcg(first), s1 = __ldcg(first + TILE_Q),
        s2 = __ldcg(first + 2 * TILE_Q), s3 = __ldcg(first + 3 * TILE_Q);
#pragma unroll 4
  for (int k = 1; k < n_items; ++k) {
    const float* pk = first + (size_t)k * 4 * TILE_Q;
    const float a0 = __ldcg(pk), a1 = __ldcg(pk + TILE_Q),
                a2 = __ldcg(pk + 2 * TILE_Q), a3 = __ldcg(pk + 3 * TILE_Q);
    s0 += a0;
    s1 += a1;
    s2 += a2;
    s3 += a3;
  }
  out[q] = s0;
  out[nq + q] = s1;
  out[2 * nq + q] = s2;
  out[3 * nq + q] = s3;
}

extern "C" int grid_gather_item_chunks() { return ITEM_CHUNKS; }

extern "C" int grid_gather(const void* item_tile, const void* item_lo,
                           const void* item_hi, int n_slots,
                           const void* tile_first, const void* tile_items,
                           void* done, int n_tiles, int chunk,
                           const void* qpT, const void* qr2, const void* qnsT,
                           const void* pdata, const void* cbox,
                           void* partial, void* out, void* stream) {
  // the wrapper keeps 0 < chunk <= 1024: 40 bytes a photon staged and 2
  // bytes a photon of each warp's list, 48 KB at most; above 48 KB the
  // block must opt in to dynamic shared memory
  const size_t smem = (size_t)chunk * (2 * sizeof(float4) + sizeof(float2) +
                                       WARPS * sizeof(unsigned short));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_slots > 0) {
    grid_gather_kernel<<<n_slots, TILE_Q, smem, (cudaStream_t)stream>>>(
        (const int*)item_tile, (const int*)item_lo, (const int*)item_hi,
        (const int*)tile_first, (const int*)tile_items, (int*)done, chunk,
        (const float*)qpT, (const float*)qr2, (const float*)qnsT,
        (const float*)pdata, (const float*)cbox, n_tiles * TILE_Q,
        (float*)partial, (float*)out);
  }
  return (int)cudaGetLastError();
}
