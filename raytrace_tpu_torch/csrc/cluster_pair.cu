// Pair pass of the cluster engine: Möller–Trumbore of each ray tile against
// the triangles of every cluster its kept pairs name, each tile's pairs cut
// into work items of at most ITEM_PAIRS pairs, one block per item.
//
// Replaces: raytrace_tpu/ops/cluster_intersect.py `_pair_kernel` (launched
// by `intersect_clusters` once per round of 2^17 pairs), which visits one
// (tile, cluster) pair per grid step, tests the tile's rays against the
// cluster's [9, S] slab on the VPU and folds the result into the tile's
// output block; the rounds are min-combined outside the kernel.
//
// Bound on the H100: fp32 instruction issue — 53 operations per
// ray-triangle test (as K1), against 36 bytes per triangle that every ray of
// the tile shares, read once per pair. Loads compete with that arithmetic
// for issue slots, so the design makes each triangle load serve two tests
// and skips, exactly, the work a hit cannot need:
//
// - Staging. For each pair the block stages the cluster's triangles in
//   shared memory as v0, e1 = v1 − v0 and e2 = v2 − v0 (the plain version's
//   fp32 differences, formed once), 36 bytes a triangle (18 KB at S = 512),
//   read back as two 128-bit and one 32-bit broadcast load.
// - Two rays a thread, two triangle halves. A block of tile_rays threads
//   holds each ray twice: the first half of its warps tests triangles
//   [0, ⌈S/2⌉), the second half the rest, each thread two rays (lane and
//   lane + 32 of its 64), so each staged triangle serves two tests. At the
//   end of the item each ray keeps the better of its halves' (t, idx). The
//   test loop is unrolled 8 times to amortise the loop's own instructions.
// - A warp-level gate, exact. Each test runs in two halves: pvec, det, its
//   reciprocal, tvec and beta; then qvec, gamma and t. A hit needs det != 0
//   and 0 <= beta <= 1 (beta + gamma <= 1 with gamma >= 0 rounds to at
//   least beta, and a NaN fails beta >= 0), so where no lane of the warp
//   meets that for a ray slot and a triangle, the second half cannot move
//   any lane's best and is skipped. A warp none of whose 64 rays has a
//   window, !(tmin < min(tmax, 1e30)), skips its tests: `t > tmin && t <
//   hi` cannot hold when tmin >= hi or either is NaN, and hi only falls
//   on a hit. Neither skip changes a bit of the output.
// - Work items. The pairs arrive sorted tile-major and, inside a tile, by
//   ascending cluster; the wrapper cuts each tile's range [begin, end) into
//   items of at most ITEM_PAIRS pairs (`work_items`: cumsum and searchsorted
//   on the device), so a tile of 287 pairs (4× the mean at config[4]) does
//   not hold the launch's tail. A tile of one item writes its rays' (t,
//   idx); otherwise each item writes them to scratch and the last of the
//   tile's blocks to finish (a per-tile counter behind a __threadfence)
//   combines them in item order. A tile without pairs has no item and keeps
//   the defined miss (1e30, 0) the wrapper wrote.
//
// Within one item half, each ray scans (cluster, k) ascending with a strict
// `<` against min(tmax, 1e30, running best): the first triangle at the
// smallest t wins, and since the index cluster·S + k grows with (cluster,
// k), that is the smallest t, then the lowest index. Halves and items are
// combined by the same rule (smaller t; at equal t the lower index), which
// does not depend on the order, so the result is JAX's per-round strict `<`
// fold and its min-combine across rounds. The reciprocal is IEEE
// round-to-nearest (`__frcp_rn`, the correctly rounded 1/det of the plain
// version); where det is 0 the test fails on `det != 0` whatever the
// reciprocal gives. Operation order is JAX's, and the library is built with
// --fmad=false, so (t, idx) equal the plain version's bit for bit.
#include <cuda_runtime.h>

#define BIG 1e30f
#define FULL 0xffffffffu
#define MAX_RAYS 256  // rays per tile at most: the engine's 128 or 256
// P: pairs per work item. Tiles hold 1-287 pairs at config[4] (mean 69.5);
// P = 8 was the fastest of 8-64 there, one item per tile 1.5x slower
// (utils/sweep.py, PERF.md)
#define ITEM_PAIRS 8

struct Ray {
  float ox, oy, oz, dx, dy, dz, lo;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// the first half of a ray-triangle test, the plain version's operations in
// its order: pvec, det, its reciprocal, tvec and beta
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

// the second half: qvec, gamma, t and the bounds; a hit lowers the ray's
// bound hi to its t, so a later triangle must be strictly nearer
__device__ __forceinline__ void mt_end(const Ray& r, const Half& h,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       int idx, float& hi, float& best_t,
                                       int& best_i) {
  // qvec = tvec x e1
  const float qx = h.tvy * e1z - h.tvz * e1y;
  const float qy = h.tvz * e1x - h.tvx * e1z;
  const float qz = h.tvx * e1y - h.tvy * e1x;
  const float gamma = (r.dx * qx + r.dy * qy + r.dz * qz) * h.inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * h.inv_det;
  if (h.pass && gamma >= 0.f && h.beta + gamma <= 1.f && t > r.lo &&
      t < hi) {
    hi = t;
    best_t = t;
    best_i = idx;
  }
}

// (t1, i1) beats (t0, i0): the smaller t, at equal t the lower index. A
// miss is (1e30, 0) and every hit has t < 1e30, so misses lose to hits
__device__ __forceinline__ bool better(float t1, int i1, float t0, int i0) {
  return t1 < t0 || (t1 == t0 && i1 < i0);
}

__global__ void __launch_bounds__(MAX_RAYS) cluster_pair_kernel(
    const int* __restrict__ pair_cluster, const int* __restrict__ item_tile,
    const int* __restrict__ item_lo, const int* __restrict__ item_hi,
    const int* __restrict__ tile_first, const int* __restrict__ tile_items,
    int* __restrict__ done, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const float* __restrict__ tv, int S,
    float* __restrict__ part_t, int* __restrict__ part_i,
    float* __restrict__ t_out, int* __restrict__ i_out) {
  // v0x v0y v0z e1x | e1y e1z e2x e2y | e2z of each staged triangle; at the
  // end, the second half's (t, idx) of each ray
  extern __shared__ float4 smem[];
  float4* s_a = smem;
  float4* s_b = smem + S;
  float* s_c = (float*)(smem + 2 * S);
  __shared__ bool s_last;

  const int item = blockIdx.x;
  const int tile = item_tile[item];
  if (tile < 0) return;  // a slot past the last item: block-uniform

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half_warps = blockDim.x >> 6;
  const int half = warp >= half_warps;
  const int ray0 = (warp - half * half_warps) * 64 + lane;  // and ray0 + 32
  const size_t base = (size_t)tile * blockDim.x;
  Ray ray[2];
  float hi[2], best_t[2];
  int best_i[2];
  bool live = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = base + ray0 + 32 * h;
    ray[h].ox = o[3 * r + 0]; ray[h].oy = o[3 * r + 1];
    ray[h].oz = o[3 * r + 2];
    ray[h].dx = d[3 * r + 0]; ray[h].dy = d[3 * r + 1];
    ray[h].dz = d[3 * r + 2];
    ray[h].lo = tmin[r];
    hi[h] = nan_min(tmax[r], BIG);
    best_t[h] = BIG;
    best_i[h] = 0;
    live = live || ray[h].lo < hi[h];
  }
  live = __any_sync(FULL, live);

  const int s_half = (S + 1) >> 1;
  const int k0 = half ? s_half : 0, k1 = half ? S : s_half;
  const int p1 = item_hi[item];
  for (int p = item_lo[item]; p < p1; ++p) {
    const int c = pair_cluster[p];
    const float* __restrict__ tri = tv + (size_t)c * 9 * S;
    __syncthreads();  // the previous cluster's triangles are used up
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      const float v0x = tri[0 * S + k], v0y = tri[1 * S + k],
                  v0z = tri[2 * S + k];
      const float e1x = tri[3 * S + k] - v0x, e1y = tri[4 * S + k] - v0y,
                  e1z = tri[5 * S + k] - v0z;
      const float e2x = tri[6 * S + k] - v0x, e2y = tri[7 * S + k] - v0y,
                  e2z = tri[8 * S + k] - v0z;
      s_a[k] = make_float4(v0x, v0y, v0z, e1x);
      s_b[k] = make_float4(e1y, e1z, e2x, e2y);
      s_c[k] = e2z;
    }
    __syncthreads();
    if (!live) continue;  // warp-uniform
    const int idx0 = c * S;
#pragma unroll 8  // the loop's own instructions, amortised
    for (int k = k0; k < k1; ++k) {
      const float4 a = s_a[k], b = s_b[k];
      const float e2z = s_c[k];
      Half hf[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hf[h] = mt_begin(ray[h], a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e2z);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (__any_sync(FULL, hf[h].pass))  // warp-uniform
          mt_end(ray[h], hf[h], a.w, b.x, b.y, b.z, b.w, e2z, idx0 + k,
                 hi[h], best_t[h], best_i[h]);
    }
  }

  // the second half hands its (t, idx) to the first through shared memory
  float* s_t = (float*)smem;
  int* s_i = (int*)(s_t + blockDim.x);
  __syncthreads();
  if (half) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_t[ray0 + 32 * h] = best_t[h];
      s_i[ray0 + 32 * h] = best_i[h];
    }
  }
  __syncthreads();
  const int n_items = tile_items[tile];
  if (!half) {
    float* ot = n_items == 1 ? t_out + base
                             : part_t + (size_t)item * blockDim.x;
    int* oi = n_items == 1 ? i_out + base : part_i + (size_t)item * blockDim.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = ray0 + 32 * h;
      if (better(s_t[j], s_i[j], best_t[h], best_i[h])) {
        best_t[h] = s_t[j];
        best_i[h] = s_i[j];
      }
      ot[j] = best_t[h];
      oi[j] = best_i[h];
    }
  }
  if (n_items == 1) return;  // block-uniform

  // the last of the tile's items to finish combines them in item order:
  // each block's stores are made visible device-wide before its count, so
  // the block that counts last sees every item's rows
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + tile, 1) == n_items - 1;
  __syncthreads();
  if (!s_last) return;
  const int j = threadIdx.x;
  const size_t first = (size_t)tile_first[tile] * blockDim.x + j;
  float t = __ldcg(part_t + first);
  int i = __ldcg(part_i + first);
  for (int m = 1; m < n_items; ++m) {
    const float t1 = __ldcg(part_t + first + (size_t)m * blockDim.x);
    const int i1 = __ldcg(part_i + first + (size_t)m * blockDim.x);
    if (better(t1, i1, t, i)) {
      t = t1;
      i = i1;
    }
  }
  t_out[base + j] = t;
  i_out[base + j] = i;
}

extern "C" int cluster_pair_item_pairs() { return ITEM_PAIRS; }

extern "C" int cluster_pair(const void* pair_cluster, const void* item_tile,
                            const void* item_lo, const void* item_hi,
                            int n_slots, const void* tile_first,
                            const void* tile_items, void* done, int tile_rays,
                            const void* o, const void* d, const void* tmin,
                            const void* tmax, const void* tv, int S,
                            void* part_t, void* part_i, void* t_out,
                            void* i_out, void* stream) {
  if (tile_rays <= 0 || tile_rays % 64 || tile_rays > MAX_RAYS || S <= 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)9 * S * sizeof(float);
  if (smem < (size_t)2 * tile_rays * sizeof(float))
    smem = (size_t)2 * tile_rays * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_slots > 0) {
    cluster_pair_kernel<<<n_slots, tile_rays, smem, (cudaStream_t)stream>>>(
        (const int*)pair_cluster, (const int*)item_tile,
        (const int*)item_lo, (const int*)item_hi, (const int*)tile_first,
        (const int*)tile_items, (int*)done, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const float*)tv, S, (float*)part_t, (int*)part_i, (float*)t_out,
        (int*)i_out);
  }
  return (int)cudaGetLastError();
}
