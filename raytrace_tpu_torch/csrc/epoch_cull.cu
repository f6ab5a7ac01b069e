// Epoch-windowed slab cull: one byte per (cluster, 256-ray tile), bit k set
// when a ray of the tile's 32-ray subtile k enters the cluster's box inside
// its current epoch window.
//
// Replaces: raytrace_tpu/ops/epoch_intersect.py `_cull_kernel` (body
// `_cull_kernel_body`, launched by `_cull_bits`), which tests groups of 8
// tiles against 2,048-cluster chunks as dense [256, chunk] blocks, ORs each
// 32-row slice into a bit and writes int32 [n_tiles, C].
//
// Bound on the H100: fp32 instruction issue. Each ray-cluster test is 32
// operations (6 differences, 6 products, 11 min/max, 5 compares, 4 ands) on
// 24 bytes of box that every ray of a tile shares; the output is one byte
// per 256 tests, so memory moves little next to the arithmetic. Most of
// what a launch asks is wasted work: a ray crosses a few dozen of thousands
// of boxes, rays of a photon launch leave the scene box, and rays that an
// earlier epoch resolved test every box and set no bit. So the design cuts
// instructions per test and tests per launch:
//
// - Exact early-outs on a hierarchy of hulls. Each ray first runs the same
//   test against the scene box S = [smin, smax], which holds every real
//   cluster (index < n_real), then against the hull of each group of GROUP
//   consecutive real clusters (clusters are in BVH-leaf order, so a group
//   is spatially compact; the last group may be partial). x ↦ (x − o)·inv
//   rounds monotonically, so without NaN each member's slab values lie
//   between its hull's on every axis: tn ≥ tn_H, tf ≤ tf_H, tnc ≥ tnc_H. A
//   hit needs tn ≤ tf, tf > tmin and w0 ≤ tnc ≤ tf (tnc = max(tn, tmin)),
//   tnc < w1 and tnc < tbest, hence tn_H ≤ tf_H, tf_H > tmin, w0 ≤ tf_H,
//   tnc_H < w1, tnc_H < tbest and w0 < tbest. A NaN among a cluster's slab
//   values makes tn and tf NaN and the cluster misses; a NaN among a hull's
//   (0·inf where a direction component is denormal or an origin lies on a
//   face plane, or a NaN vertex) means "may hit": with finite boxes and
//   directions such a ray hits no member, but with an unbounded cluster and
//   an infinite direction component it can. A warp none of whose rays may
//   hit S tests no hull; a group none of whose hull tests passes on the
//   warp gets that warp's bits 0 for all its clusters, untested. A chunk of
//   boxes that no warp of the block must test is written as zeros without
//   staging. Padding clusters (index ≥ n_real, boxes (+inf, −inf), whose
//   slab (−inf, +inf) passes every live ray in epoch 0) belong to no group:
//   a 32-box word that holds one is tested by every warp, its real clusters
//   giving 0 exactly where skipped. So the mask is the plain version's bit
//   for bit. ops/epoch_kernels.py `group_precull_plain` is the same
//   predicate (`precull_plain` on S); tests/test_torch_epoch_precull.py
//   holds it exact.
// - min.NaN.f32 / max.NaN.f32 (sm_80+): torch.minimum's NaN rule in one
//   instruction instead of two compares and a select.
// - Four rays per thread, so each box — two 128-bit broadcast loads from
//   shared memory — serves four tests. Warp w of a block holds rays
//   [128 w, 128 w + 128) of its four tiles: subtiles 4(w % 2) .. +3 of tile
//   w / 2. Each thread ORs its hits into a word per ray over 32 boxes, and
//   one `__reduce_or_sync` per word gives the subtiles' bits; a warp that
//   skips a word leaves it 0, and the block writes each cluster's four tile
//   bytes, its warps' nibbles, as one 32-bit store.
//
// Optional counter (int64 [2], null unless the caller counts): the box
// tests the block's live warps ran on real clusters and hulls, S's
// included, and the tests the launch asked for (live warps × real
// clusters); one atomic add per block and value. ops/epoch_kernels.py
// `cull_tests_plain` counts the same.
//
// The mask is cluster-major, uint8 [C, n_tiles]: the order the pair
// compaction reads (JAX transposes its int32 mask for it). Tiles past the
// live prefix (rays sort dead-last) write zeros without testing; the live
// count is read on the device, so the host never waits. Operation order is
// the plain version's and the library is built with --fmad=false, so the
// mask equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256
#define THREADS 256
#define RPT 4                            // rays per thread
#define TILES (THREADS * RPT / TILE)     // tiles per block
#define CHUNK 256                        // boxes staged per pass
#define STEP 8                           // boxes per unrolled step
#define CLUSTERS_PER_BLOCK 1024
#define GROUP 32                         // real clusters under one hull
#define GROUPS (CLUSTERS_PER_BLOCK / GROUP)  // hulls per block
#define FULL 0xffffffffu

static_assert(CHUNK % GROUP == 0 && (GROUP % 32 == 0 || 32 % GROUP == 0) &&
                  GROUPS <= 64,
              "a block's groups are bits of one 64-bit mask");

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, lo, tb, a, b;  // tmin, tbest, w0, w1
};

// entry and exit distances of the ray through box [bmin, bmax]: the plain
// version's operations in its order
__device__ __forceinline__ void slab(const Ray& r, float4 bmin, float4 bmax,
                                     float& tn, float& tf) {
  const float tx0 = (bmin.x - r.ox) * r.ix, tx1 = (bmax.x - r.ox) * r.ix;
  const float ty0 = (bmin.y - r.oy) * r.iy, ty1 = (bmax.y - r.oy) * r.iy;
  const float tz0 = (bmin.z - r.oz) * r.iz, tz1 = (bmax.z - r.oz) * r.iz;
  tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
               nan_min(tz0, tz1));
  tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
               nan_max(tz0, tz1));
}

// the entry distance clamped to the ray start puts each cluster in exactly
// one epoch window [w0, w1); resolved rays cull nothing
__device__ __forceinline__ bool window_hit(const Ray& r, float tn, float tf) {
  const float tnc = nan_max(tn, r.lo);
  return tn <= tf && tf > r.lo && tnc >= r.a && tnc < r.b && tnc < r.tb;
}

// a hull's necessary conditions (see the note above)
__device__ __forceinline__ bool may_hit(const Ray& r, float tn, float tf) {
  const float tnc = nan_max(tn, r.lo);
  return tn != tn || (tn <= tf && tf > r.lo && r.a <= tf && tnc < r.b &&
                      tnc < r.tb && r.a < r.tb);
}

// the bits of the groups that hold block-relative clusters [k, k + n)
__device__ __forceinline__ uint64_t group_bits(int k, int n) {
  const int g0 = k / GROUP, g1 = (k + n - 1) / GROUP;
  return ((2ull << (g1 - g0)) - 1ull) << g0;  // 64 bits: 2 << 63 wraps to 0
}

// the block's bytes of cluster c: byte t for tile tile0 + t
__device__ __forceinline__ void store_bytes(uint8_t* out, int c, int n_tiles,
                                            int tile0, uint32_t bytes) {
  uint8_t* p = out + (size_t)c * n_tiles + tile0;
  if (n_tiles % TILES == 0) {  // aligned: tile0 and the row are multiples of 4
    *reinterpret_cast<uint32_t*>(p) = bytes;
  } else {
    for (int t = 0; t < TILES && tile0 + t < n_tiles; ++t)
      p[t] = (uint8_t)(bytes >> (8 * t));
  }
}

__global__ void __launch_bounds__(THREADS) epoch_cull_kernel(
    const float* __restrict__ o, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tbest,
    const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ box, const float* __restrict__ gmin,
    const float* __restrict__ gmax, const int* __restrict__ n_live,
    int n_clusters, int n_real, int n_tiles, uint8_t* __restrict__ out,
    unsigned long long* __restrict__ counter) {
  __shared__ float4 s_box[2][CHUNK];
  __shared__ float4 s_hull[2][GROUPS];
  // per warp and 32-box word: the words of its RPT subtiles
  __shared__ uint4 s_bits[THREADS / 32][CHUNK / 32];
  __shared__ uint64_t s_groups[THREADS / 32];  // the groups each warp tests
  __shared__ unsigned s_ran[THREADS / 32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * TILES;
  const int c_begin = blockIdx.y * CLUSTERS_PER_BLOCK;
  const int c_end = min(n_clusters, c_begin + CLUSTERS_PER_BLOCK);
  const int live = *n_live;
  if (tile0 * TILE >= live) {  // only dead tiles: zeros, no tests
    for (int c = c_begin + threadIdx.x; c < c_end; c += THREADS)
      store_bytes(out, c, n_tiles, tile0, 0u);
    return;
  }

  // real clusters of this block: [c_begin, c_real), in its groups
  // [g_begin, g_begin + n_hulls)
  const int c_real = max(c_begin, min(c_end, n_real));
  const int g_begin = c_begin / GROUP;
  const int n_hulls = (c_real - c_begin + GROUP - 1) / GROUP;
  if (threadIdx.x < n_hulls) {
    const int g = g_begin + threadIdx.x;
    s_hull[0][threadIdx.x] = make_float4(gmin[3 * g + 0], gmin[3 * g + 1],
                                         gmin[3 * g + 2], 0.f);
    s_hull[1][threadIdx.x] = make_float4(gmax[3 * g + 0], gmax[3 * g + 1],
                                         gmax[3 * g + 2], 0.f);
  }

  // a dead tile's rays get tmin NaN: every comparison with it fails, so
  // they set no bit, padding clusters included, and pass no hull without
  // NaN
  const int tile = tile0 + warp / 2;
  const bool tile_live = tile < n_tiles && tile * TILE < live;
  const float4 smin = make_float4(box[0], box[1], box[2], 0.f);
  const float4 smax = make_float4(box[3], box[4], box[5], 0.f);
  Ray ray[RPT];
  bool may = false;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    Ray& r = ray[q];
    if (tile_live) {
      const int i = tile0 * TILE + warp * (RPT * 32) + q * 32 + lane;
      r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
      r.ix = inv[3 * i + 0]; r.iy = inv[3 * i + 1]; r.iz = inv[3 * i + 2];
      r.lo = tmin[i]; r.tb = tbest[i]; r.a = w0[i]; r.b = w1[i];
    } else {
      r.ox = r.oy = r.oz = 0.f;
      r.ix = r.iy = r.iz = 1.f;
      r.lo = __int_as_float(0x7fffffff);
      r.tb = r.a = r.b = 0.f;
    }
    if (n_hulls > 0) {
      float tn, tf;
      slab(r, smin, smax, tn, tf);
      may |= may_hit(r, tn, tf);
    }
  }
  const bool skip = !__any_sync(FULL, may);
  __syncthreads();  // the hulls are staged

  // the groups some ray of the warp may hit
  uint64_t groups = 0;
  if (!skip) {
    uint64_t bits = 0;
#pragma unroll 1
    for (int j = 0; j < n_hulls; ++j) {
      const float4 lo = s_hull[0][j], hi = s_hull[1][j];
      bool m = false;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float tn, tf;
        slab(ray[q], lo, hi, tn, tf);
        m |= may_hit(ray[q], tn, tf);
      }
      bits |= (uint64_t)m << j;
    }
    groups = ((uint64_t)__reduce_or_sync(FULL, (unsigned)(bits >> 32)) << 32) |
             __reduce_or_sync(FULL, (unsigned)bits);
  }
  if (lane == 0) s_groups[warp] = groups;
  __syncthreads();
  uint64_t block_groups = 0;  // the groups some warp of the block tests
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) block_groups |= s_groups[w];
  // tests run: S and the hulls (counted only where n_hulls > 0)
  unsigned ran = n_hulls > 0 ? 1u + (skip ? 0u : (unsigned)n_hulls) : 0u;

  for (int base = c_begin; base < c_end; base += CHUNK) {
    const int cnt = min(CHUNK, c_end - base);
    // a chunk of real clusters in groups no warp tests: zeros, no tests
    if (base + cnt <= n_real &&
        !(block_groups & group_bits(base - c_begin, cnt))) {
      for (int c = base + threadIdx.x; c < base + cnt; c += THREADS)
        store_bytes(out, c, n_tiles, tile0, 0u);
      continue;
    }
    __syncthreads();
    {
      const int k = threadIdx.x;  // THREADS == CHUNK; NaN boxes pad the chunk
      const float nan = __int_as_float(0x7fffffff);
      float4 lo = make_float4(nan, nan, nan, nan), hi = lo;
      if (k < cnt) {
        const int c = base + k;
        lo = make_float4(cmin[3 * c + 0], cmin[3 * c + 1], cmin[3 * c + 2],
                         0.f);
        hi = make_float4(cmax[3 * c + 0], cmax[3 * c + 1], cmax[3 * c + 2],
                         0.f);
      }
      s_box[0][k] = lo;
      s_box[1][k] = hi;
    }
    __syncthreads();
    const int words = (cnt + 31) / 32;
    for (int kw = 0; kw < words; ++kw) {
      uint32_t bits[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) bits[q] = 0u;
      // a word holding padding is tested by every warp, its real boxes
      // giving 0 exactly where the warp skipped their group
      const int c0 = base + 32 * kw, c1 = min(c0 + 32, c_end);
      if (c1 > n_real || (groups & group_bits(c0 - c_begin, c1 - c0))) {
        ran += (unsigned)max(0, min(c1, n_real) - c0);
#pragma unroll 1
        for (int g = 0; g < 32; g += STEP) {
          uint32_t step_bits[RPT];
#pragma unroll
          for (int q = 0; q < RPT; ++q) step_bits[q] = 0u;
#pragma unroll
          for (int j = 0; j < STEP; ++j) {
            const int k = kw * 32 + g + j;
            const float4 lo = s_box[0][k], hi = s_box[1][k];
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              float tn, tf;
              slab(ray[q], lo, hi, tn, tf);
              if (window_hit(ray[q], tn, tf)) step_bits[q] |= 1u << j;
            }
          }
#pragma unroll
          for (int q = 0; q < RPT; ++q) bits[q] |= step_bits[q] << g;
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) bits[q] = __reduce_or_sync(FULL, bits[q]);
      }
      if (lane == 0)
        s_bits[warp][kw] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    }
    __syncthreads();
    const int k = threadIdx.x;
    if (k < cnt) {
      const int kw = k >> 5, kb = k & 31;
      uint32_t bytes = 0u;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        const uint4 v = s_bits[w][kw];
        const uint32_t nib = ((v.x >> kb) & 1u) | (((v.y >> kb) & 1u) << 1) |
                             (((v.z >> kb) & 1u) << 2) |
                             (((v.w >> kb) & 1u) << 3);
        bytes |= nib << (4 * w);  // warp w: tile w / 2, bits 4(w % 2)..+3
      }
      store_bytes(out, base + k, n_tiles, tile0, bytes);
    }
  }

  if (counter != nullptr) {  // live warps only: a dead tile asks nothing
    if (lane == 0) s_ran[warp] = tile_live ? ran : 0u;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0, live_warps = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        const int t = tile0 + w / 2;
        total += s_ran[w];
        live_warps += t < n_tiles && t * TILE < live;
      }
      atomicAdd(counter, total);
      atomicAdd(counter + 1, live_warps * (unsigned long long)(c_real - c_begin));
    }
  }
}

extern "C" int epoch_cull(const void* o, const void* inv, const void* tmin,
                          const void* tbest, const void* w0, const void* w1,
                          const void* cmin, const void* cmax, const void* box,
                          const void* gmin, const void* gmax,
                          const void* n_live, int n_clusters, int n_real,
                          int n_tiles, void* out, void* counter,
                          void* stream) {
  if (n_tiles > 0 && n_clusters > 0) {
    const dim3 grid((n_tiles + TILES - 1) / TILES,
                    (n_clusters + CLUSTERS_PER_BLOCK - 1) / CLUSTERS_PER_BLOCK);
    epoch_cull_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)inv, (const float*)tmin,
        (const float*)tbest, (const float*)w0, (const float*)w1,
        (const float*)cmin, (const float*)cmax, (const float*)box,
        (const float*)gmin, (const float*)gmax, (const int*)n_live,
        n_clusters, n_real, n_tiles, (uint8_t*)out,
        (unsigned long long*)counter);
  }
  return (int)cudaGetLastError();
}
