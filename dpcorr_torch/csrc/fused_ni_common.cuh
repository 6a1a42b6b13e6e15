// Device code shared by the fused NI kernel (csrc/fused_ni.cu) and its
// stage ladder (csrc/fused_ni_ladder.cu): the block shape, Philox4x32-10
// and its tags, the 23-bit uniforms, Laplace and Gaussian draws, the
// pinned Cholesky step and the sign sweep's packed counts. Both kernels
// take these from here, so every level of the ladder is a prefix of the
// kernel's own work by construction. ops/_build.py adds this header's
// bytes to each library's digest, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory one block may take on sm_90 (227 KB), less a
// margin for the static scratch; `_SMEM_LIMIT` in ops/fused_ni.py mirrors it
constexpr size_t kSmemLimit = 232448 - 2048;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kTwoPi = 6.28318530717958647692f;

// second counter word of each in-kernel stream
constexpr uint32_t kTagPairs = 0, kTagFlips = 1, kTagBatch = 2,
                   kTagScalar = 3;

// Philox4x32-10 round keys: they depend on the replication only.
struct RoundKeys {
  uint32_t x[10], y[10];
};

__device__ __forceinline__ RoundKeys round_keys(int2 seed) {
  RoundKeys rk;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    rk.x[i] = static_cast<uint32_t>(seed.x) + i * 0x9E3779B9u;
    rk.y[i] = static_cast<uint32_t>(seed.y) + i * 0xBB67AE85u;
  }
  return rk;
}

// Philox4x32-10 (Random123) on counter (c0, c1, 0, 0).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1,
                                        const RoundKeys& rk) {
  uint4 c = make_uint4(c0, c1, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ rk.x[i], lo1, hi0 ^ c.w ^ rk.y[i], lo0);
  }
  return c;
}

// The words of pass 1's step r (four consecutive observations, or
// positions in the ladder): counters 2r and 2r + 1 of tag 0, the pair
// (u1, u2) of step element c in words (2c, 2c + 1) of a then b.
__device__ __forceinline__ void quad_words(uint32_t r, const RoundKeys& rk,
                                           uint32_t w1[4], uint32_t w2[4]) {
  const uint4 a = philox(2u * r, kTagPairs, rk);
  const uint4 b = philox(2u * r + 1u, kTagPairs, rk);
  w1[0] = a.x; w2[0] = a.y; w1[1] = a.z; w2[1] = a.w;
  w1[2] = b.x; w2[2] = b.y; w1[3] = b.z; w2[3] = b.w;
}

// 23-bit rule of pallas_ni.py `_uniform`, (b23 + 0.5) 2^-23: the float
// 1 + b23 2^-23 is built in the exponent field, and subtracting 1 - 2^-24
// is exact, so the result equals the rule bit for bit.
__device__ __forceinline__ float unit23(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                   0x1.fffffep-1f);
}

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// sign(v - mu) for finite v and mu (no flush to zero, so v - mu is 0 only
// when v == mu)
__device__ __forceinline__ int sign_of(float v, float mu) {
  return (v > mu) - (v < mu);
}

// Inverse-CDF Laplace(0, 1) of pallas_ni.py `_laplace_from_uniform`.
__device__ __forceinline__ float laplace1(float u) {
  const float c = u - 0.5f;
  return -sign_f(c) * log1pf(-2.f * fabsf(c));
}

// Horner step without contraction: acc * x + c rounded twice, as the
// plain version's separate PyTorch ops round it. The rational chains
// cancel near the central/tail seam, where a fused multiply-add would
// move z by up to ~1e-4 and flip the sign of values near the mean.
__device__ __forceinline__ float horner(const float* c, int len, float x) {
  float acc = c[0];
  for (int i = 1; i < len; ++i) acc = __fadd_rn(__fmul_rn(acc, x), c[i]);
  return acc;
}

// Acklam's inverse normal CDF, pallas_ni.py `_ndtri_inline`.
__device__ __forceinline__ float ndtri_acklam(float p) {
  const float a[6] = {-3.969683028665376e+01f, 2.209460984245205e+02f,
                      -2.759285104469687e+02f, 1.383577518672690e+02f,
                      -3.066479806614716e+01f, 2.506628277459239e+00f};
  const float b[6] = {-5.447609879822406e+01f, 1.615858368580409e+02f,
                      -1.556989798598866e+02f, 6.680131188771972e+01f,
                      -1.328068155288572e+01f, 1.0f};
  const float c[6] = {-7.784894002430293e-03f, -3.223964580411365e-01f,
                      -2.400758277161838e+00f, -2.549732539343734e+00f,
                      4.374664141464968e+00f, 2.938163982698783e+00f};
  const float d[5] = {7.784695709041462e-03f, 3.224671290700398e-01f,
                      2.445134137142996e+00f, 3.754408661907416e+00f, 1.0f};
  const float q = p - 0.5f;
  const float r = __fmul_rn(q, q);
  const float central = __fmul_rn(q, horner(a, 6, r)) / horner(b, 6, r);
  const float pt = fminf(p, 1.0f - p);
  const float s = sqrtf(__fmul_rn(-2.0f, logf(pt)));
  float tail = horner(c, 6, s) / horner(d, 5, s);
  tail = q < 0.0f ? tail : -tail;
  return fabsf(q) <= 0.47575f ? central : tail;  // 0.5 - 0.02425
}

template <bool kNdtri>
__device__ __forceinline__ void gauss_pair(float u1, float u2, float& z1,
                                           float& z2) {
  if (kNdtri) {
    z1 = ndtri_acklam(u1);
    z2 = ndtri_acklam(u2);
  } else {
    const float rad = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincosf(kTwoPi * u2, &s, &c);
    z1 = rad * c;
    z2 = rad * s;
  }
}

// sqrt(1 - rho^2), once per replication
__device__ __forceinline__ float cholesky_c(float rho) {
  return sqrtf(__fsub_rn(1.0f, __fmul_rn(rho, rho)));
}

// rho z1 + sqrt(1 - rho^2) z2 with each rounding pinned, so every caller
// gets the same bits whatever the compiler contracts around it
__device__ __forceinline__ float correlate(float rho, float crho, float z1,
                                           float z2) {
  return __fmaf_rn(rho, z1, __fmul_rn(crho, z2));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The signs of one position as four byte counters (x > mu, x < mu,
// y > mu, y < mu), zero unless it holds a batch element; bitwise, not
// branching, on the mask.
__device__ __forceinline__ uint32_t sign_bytes(bool elem, float x, float y,
                                               float mu_x, float mu_y) {
  return static_cast<uint32_t>(elem & (x > mu_x)) |
         static_cast<uint32_t>(elem & (x < mu_x)) << 8 |
         static_cast<uint32_t>(elem & (y > mu_y)) << 16 |
         static_cast<uint32_t>(elem & (y < mu_y)) << 24;
}

// The sweep's count step: a lane's four positions' packed signs summed
// per batch, within the lane and then by xor shuffles over the m'/4
// lanes of a batch (m' >= 4), into cnt[0 .. nb - 1] for the lane's
// batches q0 / m' ..; returns nb: one in a batch's first lane (m' >= 4,
// else zero), two (m' = 2) or four (m' = 1). Counts stay <= m <= 128, so
// the bytes never carry. Called by the whole warp.
__device__ __forceinline__ int batch_counts(const uint32_t pk[4], int mp,
                                            int lane, uint32_t cnt[4]) {
  if (mp >= 4) {
    const int seg_lanes = mp >> 2;
    cnt[0] = pk[0] + pk[1] + pk[2] + pk[3];
    for (int off = 1; off < seg_lanes; off <<= 1)
      cnt[0] += __shfl_xor_sync(kFull, cnt[0], off);
    return (lane & (seg_lanes - 1)) == 0 ? 1 : 0;
  }
  if (mp == 2) {
    cnt[0] = pk[0] + pk[1];
    cnt[1] = pk[2] + pk[3];
    return 2;
  }
  cnt[0] = pk[0]; cnt[1] = pk[1]; cnt[2] = pk[2]; cnt[3] = pk[3];
  return 4;
}

// x and y sign counts of one batch from its packed word: (cx, cy), each
// in [-m, m]
__device__ __forceinline__ int2 count_pair(uint32_t v) {
  return make_int2(
      static_cast<int>(v & 0xFFu) - static_cast<int>((v >> 8) & 0xFFu),
      static_cast<int>((v >> 16) & 0xFFu) - static_cast<int>(v >> 24));
}

}  // namespace
