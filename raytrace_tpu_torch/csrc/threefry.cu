// Threefry-2x32 draws: key folds, splits, 32-bit bits and float32 uniforms
// in one launch each.
//
// Replaces no TPU kernel: the JAX package draws through `jax.random`, which
// XLA fuses into the consumers. The port ran the same hash as ~171 eager
// int64 operations a draw (core/prng.py `threefry2x32`), one launch each;
// this kernel computes what that chain computes in one.
//
// Bound on the H100: integer instruction issue. A hash is 20 rounds of
// add, rotate (one funnel shift) and xor plus 5 key injections, ~80
// integer operations. A uniform of one key is one hash for 4 bytes
// written, the walk's 3 bounce uniforms 5 hashes for 24 bytes moved:
// 17-20 operations a byte, 3-4x the card's int32 rate over its memory
// bandwidth (~1.7e13 / 3.35e12 = 5).
//
// One thread owns one lane and up to PER_THREAD consecutive counters of
// it: it reads the lane's key, folds in up to two data words
// (`fold_in(fold_in(key, a), b)`, each a threefry of (0, word)), then
// either writes the key or hashes its counters (0, c) and writes y0 ^ y1,
// as bits or as the float in [0, 1) made of the top 23 of them. The
// bounce uniforms of the photon walk (2 folds, 3 counters) thus cost 5
// hashes a lane, and no intermediate key reaches memory.
//
// Keys are int64 pairs holding uint32 words, data int64 or int32, both
// read with a stride of 0 (one value for every lane) or 1; a data word
// may also be a launch argument or the lane index (a split). The
// arithmetic is uint32 only, so the kernel equals the eager chain bit for
// bit with any compiler flags.
#include <cuda_runtime.h>

#define BLOCK 256
#define PER_THREAD 4

enum { DATA_VALUE = 0, DATA_LANE = 1, DATA_I64 = 2, DATA_I32 = 3 };
enum { OUT_KEYS = 0, OUT_BITS = 1, OUT_FLOATS = 2 };

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ROUNDS(a, b, c, d)                              \
  x0 += x1; x1 = rotl(x1, a) ^ x0;                      \
  x0 += x1; x1 = rotl(x1, b) ^ x0;                      \
  x0 += x1; x1 = rotl(x1, c) ^ x0;                      \
  x0 += x1; x1 = rotl(x1, d) ^ x0;

// jax/_src/prng.py `_threefry2x32_lowering`: 20 rounds, 5 key injections
__device__ __forceinline__ uint2 threefry(unsigned k0, unsigned k1,
                                          unsigned x0, unsigned x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  ROUNDS(13, 15, 26, 6) x0 += k1; x1 += k2 + 1u;
  ROUNDS(17, 29, 16, 24) x0 += k2; x1 += k0 + 2u;
  ROUNDS(13, 15, 26, 6) x0 += k0; x1 += k1 + 3u;
  ROUNDS(17, 29, 16, 24) x0 += k1; x1 += k2 + 4u;
  ROUNDS(13, 15, 26, 6) x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ unsigned data_word(const void* p, int kind,
                                              long long stride,
                                              unsigned value,
                                              long long lane) {
  switch (kind) {
    case DATA_LANE: return (unsigned)lane;
    case DATA_I64: return (unsigned)((const long long*)p)[lane * stride];
    case DATA_I32: return (unsigned)((const int*)p)[lane * stride];
    default: return value;
  }
}

__global__ void __launch_bounds__(BLOCK) threefry_kernel(
    const long long* __restrict__ key, long long key_stride, int n_fold,
    const void* d0, int kind0, long long stride0, unsigned value0,
    const void* d1, int kind1, long long stride1, unsigned value1,
    long long lanes, long long count, long long groups, int out_kind,
    void* __restrict__ out) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= lanes * groups) return;
  const long long lane = t / groups;
  unsigned k0 = (unsigned)key[2 * lane * key_stride];
  unsigned k1 = (unsigned)key[2 * lane * key_stride + 1];
  if (n_fold > 0) {
    const uint2 y = threefry(k0, k1, 0u,
                             data_word(d0, kind0, stride0, value0, lane));
    k0 = y.x; k1 = y.y;
  }
  if (n_fold > 1) {
    const uint2 y = threefry(k0, k1, 0u,
                             data_word(d1, kind1, stride1, value1, lane));
    k0 = y.x; k1 = y.y;
  }
  if (out_kind == OUT_KEYS) {
    long long* o = (long long*)out + 2 * lane;
    o[0] = k0;
    o[1] = k1;
    return;
  }
  const long long c0 = (t - lane * groups) * PER_THREAD;
  const long long c1 = c0 + PER_THREAD < count ? c0 + PER_THREAD : count;
  const long long base = lane * count;
  for (long long c = c0; c < c1; ++c) {
    const uint2 y = threefry(k0, k1, 0u, (unsigned)c);
    const unsigned bits = y.x ^ y.y;
    if (out_kind == OUT_BITS)
      ((long long*)out)[base + c] = bits;
    else
      ((float*)out)[base + c] = __uint_as_float((bits >> 9) | 0x3F800000u)
                                - 1.0f;
  }
}

extern "C" int threefry_draw(const void* key, long long key_stride,
                             int n_fold, const void* d0, int kind0,
                             long long stride0, unsigned value0,
                             const void* d1, int kind1, long long stride1,
                             unsigned value1, long long lanes,
                             long long count, int out_kind, void* out,
                             void* stream) {
  const long long groups =
      out_kind == OUT_KEYS ? 1 : (count + PER_THREAD - 1) / PER_THREAD;
  const long long threads = lanes * groups;
  if (threads > 0) {
    const long long grid = (threads + BLOCK - 1) / BLOCK;
    threefry_kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)key, key_stride, n_fold, d0, kind0, stride0,
        value0, d1, kind1, stride1, value1, lanes, count, groups, out_kind,
        out);
  }
  return (int)cudaGetLastError();
}
