// Fused NI/INT sign-batch replication kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of dpcorr/ops/pallas_ni.py: the inner `kernel`
// built by `_make_kernel` (:280) and launched by `_replication_call`
// (callers `_ni_sign_pallas_sums`, `ni_sign_pallas`, `sim_detail_pallas`).
// One thread block computes one whole Monte-Carlo replication of the
// north-star workload (vert-cor.R:392-419):
//
//   pass 1  observation-parallel: draw n Gaussian pairs (Box-Muller, or
//           Acklam's inverse CDF), apply the 2x2 Cholesky factor with the
//           replication's rho, clip at +-sqrt(2 ln n), keep x, y (and with
//           INT the randomized-response flip) in shared memory and
//           block-reduce the sums of the clipped values; batch-parallel in
//           the same pass, the Laplace noise 2/(m eps) of each batch j < k;
//   scalar  DP means: sum/n + Laplace * 2L/(n eps/2) (vert-cor.R:322-348);
//   sweep   position-parallel, four consecutive positions per lane: the
//           sign of each centered batch element, summed over its batch in
//           the lane and by shuffles within the warp (the TPU kernel's
//           matmul against its 0/1 matrix G, without the matrix); the
//           batch's first lane forms T_j = m X~_j Y~_j and the sums of T_j
//           and T_j^2; in the same read, the INT sign product with its own
//           DP centering;
//   out     eta_INT = c (sum of flips * signs) + one receiver Laplace term.
//
// Output: out[b] = (sum T_j, sum T_j^2, eta_INT), f32. The scalar CI
// epilogue runs in PyTorch (dpcorr_torch/ops/fused_ni.py).
//
// Positions follow the TPU kernel's padded lane-group layout
// (pallas_ni.py `_layout`, `_position_masks`): position q = row*128 + lane
// holds batch element (q / m', q % m' < m) for q < k*m', a leftover
// observation for k*m' <= q < k*m' + leftover, else padding. Observation
// o (batch o / m, element o % m; leftovers after the k*m batch elements)
// sits at position pos(o); when m is a power of two pos(o) = o. Two
// uniform sources, both compile-time:
//   external  (B, u_rows, 128) f32 uniforms read in the TPU kernel's
//             take() order (u1, u2, 8 centering rows if normalise,
//             2*rows of batch noise, then with INT 8 rows and `rows` flip
//             rows), so the kernel can be held against its plain PyTorch
//             version (dpcorr_torch/ops/fused_ni.py) on identical inputs;
//   in-kernel Philox4x32-10 keyed by the replication's two seed words, on
//             counter (i, tag, 0, 0), every word used:
//               tag 0, i = o / 2   u1, u2 of observations 2i and 2i + 1;
//               tag 1, i = o / 4   (INT) the flip uniforms of 4i .. 4i + 3;
//               tag 2, i = j / 2   ux, uy of batches 2i and 2i + 1;
//               tag 3, i = 0       the centering draws lx, ly, lxi, lyi;
//                      i = 1       (INT) the receiver draw, one word.
//             Only a stream's last call and the scalar calls leave words
//             unused. `philox_uniforms` in fused_ni.py lays the same words
//             out in take() order, so external mode on its output gives
//             this mode's results bit for bit.
// Bits become uniforms by the TPU kernel's 23-bit rule (`_uniform`):
// u = (b23 + 0.5) 2^-23 in [2^-24, 1 - 2^-24], so log and log1p stay finite.
//
// What bounds it on this card: in-kernel mode reads 12 bytes (two seed
// words, rho) and writes 12 bytes per replication, so the bound is the
// arithmetic, and its largest term is the 32-bit integer pipe (64 lanes a
// clock per SM, half the f32 rate): Philox's 32x32->64 multiplies and
// three-way xors, the uniforms' bit operations, the clip and the sign
// tests (chip_smoke.py `fused_pipe_ops` counts the work by pipe). What the
// design does about it, against the first port of this kernel:
//   1. one Philox call gives the uniforms of two observations (four words,
//      not two of four); the round keys are made once per block;
//   2. bits become floats through the exponent field, 1 + b23 2^-23, minus
//      1 - 2^-24: exact, bit-identical to the 23-bit rule, and no
//      int-to-float conversion on the 16-lane conversion pipe;
//   3. 512 threads a block and __launch_bounds__(512, 2): two blocks of
//      90-100 KB shared memory per SM at n = 10^4 hold 32 warps, not 16,
//      to hide the serial Philox rounds and the precise logf, sqrtf and
//      sincosf; the shared-memory carveout is set to its maximum so that
//      both blocks fit;
//   4. the sign sweep reads 16 consecutive bytes a lane (no bank
//      conflicts) and sums a batch's signs in the lane, then by shuffles
//      within the warp, four counts packed to a word; the batch noise is
//      drawn in pass 1, where every thread is busy, so no batch-parallel
//      phase with idle threads and a barrier follows the sweep, and the
//      quotients c / m come from a table divided once per block;
//   5. INT's sign products are taken in the same sweep, one read of each
//      position for both centerings.
// The planes stay in shared memory (2 x 4 B + 1 B with INT per position),
// so device memory carries only the 24 B per replication and each
// transcendental runs once per observation; this caps n near 28,600 at
// m = 8 (25,600 with INT), and the wrapper raises above the cap. The 8 B
// of noise per batch join the planes when they fit (`noise_fits`, as at
// n = 10^4); near the cap a second variant of each mode, chosen at
// launch, has the lanes that hold a batch's counts draw its noise in the
// sweep instead (a call's two batches in one lane, in neighbouring lanes
// joined by a shuffle, or at m' = 128 in one warp's two consecutive
// chunks), so the noise never lowers the cap and the main path's variant
// carries none of that code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (dpcorr_torch/ops/_build.py). No fast-math: the
// tolerances against the plain version assume precise logf/sinf/cosf.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {
// Mirrored by the ctypes Structure in dpcorr_torch/ops/fused_ni.py:
// eight ints, then twelve floats, no padding.
struct FusedNiParams {
  int n, m, m_pad, k, leftover, rows, u_rows, g_cols;
  float l_clip, den_x, den_y, scale_x, scale_y;
  float mu0, mu1, sig0, sig1;
  float p_keep, c_eta, scale_z;
};
}

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory one block may take on sm_90 (227 KB), less a
// margin for the static scratch; `_SMEM_LIMIT` in fused_ni.py mirrors it
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kNoiseSmem: the batch noise is drawn in pass 1 into shared memory;
// else the sweep draws it where it forms T_j (`noise_fits`)
template <bool kExt, bool kInt, bool kNdtri, bool kNorm, bool kNoiseSmem>
__global__ void __launch_bounds__(kThreads, 2)
    fused_ni_kernel(const int2* __restrict__ seeds,
                    const float* __restrict__ rhos,
                    const float* __restrict__ uniforms,
                    float* __restrict__ out, const FusedNiParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the clipped sums (read by every thread after the first barrier), and
  // the sweep's sums (written while slower warps may still read `red`)
  __shared__ float red[2][kWarps];
  __shared__ float red_t[2][kWarps];
  __shared__ int red_core[kWarps];
  __shared__ float lap[5];  // Laplace draws lx, ly, lxi, lyi, receiver
  __shared__ float frac[2 * kLanes + 1];  // c / m for c = -m .. m
  const int plane = p.rows * kLanes;
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + plane;
  signed char* flips = reinterpret_cast<signed char*>(ys + plane);
  // per batch, after the planes when it fits (plane is a multiple of 128)
  float2* noise = reinterpret_cast<float2*>(flips + (kInt ? plane : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const float rho = rhos[b];
  const float crho = sqrtf(1.0f - rho * rho);
  const float* u =
      kExt ? uniforms + static_cast<size_t>(b) * p.u_rows * kLanes : nullptr;
  const RoundKeys rk = round_keys(seeds[b]);
  const int n = p.n, m = p.m, mp = p.m_pad;
  const int kmp = p.k * mp;
  const int km = p.k * m;
  const int end = kmp + p.leftover;
  // row offsets of each draw in an external block (the take() order)
  const int row_std = 2 * p.rows;
  const int row_noise = kNorm ? row_std + 8 : row_std;
  const int row_int = row_noise + 2 * p.rows;
  const int row_flip = row_int + 8;

  // observation -> position; o / m by a multiply-high, exact for
  // o * (ceil(2^32 / m) m - 2^32) < 2^32, i.e. for any n that fits
  const bool ident = m == mp;
  const uint32_t magic =
      ident ? 0u : 0xFFFFFFFFu / static_cast<uint32_t>(m) + 1u;
  auto position = [&](int o) {
    if (ident) return o;
    if (o >= km) return kmp + (o - km);
    const int j = static_cast<int>(__umulhi(static_cast<uint32_t>(o), magic));
    return j * mp + (o - j * m);
  };

  // the batch means' quotients, divided once per block
  const float mf = static_cast<float>(m);
  for (int i = tid; i <= 2 * m; i += kThreads)
    frac[i] = static_cast<float>(i - m) / mf;

  // ---- scalar draws, once per block
  if (tid == 0) {
    float l[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (kExt) {
      if (kNorm) {
        l[0] = laplace1(u[row_std * kLanes]);
        l[1] = laplace1(u[(row_std + 1) * kLanes]);
      }
      if (kInt) {
        l[2] = laplace1(u[row_int * kLanes]);
        l[3] = laplace1(u[(row_int + 1) * kLanes]);
        l[4] = laplace1(u[(row_int + 2) * kLanes]);
      }
    } else {
      if (kNorm) {
        const uint4 r = philox(0u, kTagScalar, rk);
        l[0] = laplace1(unit23(r.x));
        l[1] = laplace1(unit23(r.y));
        l[2] = laplace1(unit23(r.z));
        l[3] = laplace1(unit23(r.w));
      }
      if (kInt) l[4] = laplace1(unit23(philox(1u, kTagScalar, rk).x));
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) lap[i] = l[i];
  }

  // ---- pass 1: four observations per thread and step
  const bool vec =
      ident && (!kExt || (reinterpret_cast<uintptr_t>(u) & 15) == 0);
  float sum_x = 0.f, sum_y = 0.f;
  const int quads = (n + 3) >> 2;
  for (int r = tid; r < quads; r += kThreads) {
    const int o0 = 4 * r;
    float u1[4], u2[4], uf[4];
    int q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = o0 + c < n ? position(o0 + c) : -1;
    if (kExt) {
      if (vec) {  // the four positions are o0 .. o0 + 3, inside the plane
        const float4 a = *reinterpret_cast<const float4*>(u + o0);
        const float4 bb = *reinterpret_cast<const float4*>(u + plane + o0);
        u1[0] = a.x; u1[1] = a.y; u1[2] = a.z; u1[3] = a.w;
        u2[0] = bb.x; u2[1] = bb.y; u2[2] = bb.z; u2[3] = bb.w;
        if (kInt) {
          const float4 f =
              *reinterpret_cast<const float4*>(u + row_flip * kLanes + o0);
          uf[0] = f.x; uf[1] = f.y; uf[2] = f.z; uf[3] = f.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool live = q[c] >= 0;
          u1[c] = live ? u[q[c]] : 0.5f;
          u2[c] = live ? u[plane + q[c]] : 0.5f;
          if (kInt) uf[c] = live ? u[row_flip * kLanes + q[c]] : 0.5f;
        }
      }
    } else {
      const uint4 a = philox(2u * r, kTagPairs, rk);
      const uint4 bb = philox(2u * r + 1u, kTagPairs, rk);
      u1[0] = unit23(a.x);  u2[0] = unit23(a.y);
      u1[1] = unit23(a.z);  u2[1] = unit23(a.w);
      u1[2] = unit23(bb.x); u2[2] = unit23(bb.y);
      u1[3] = unit23(bb.z); u2[3] = unit23(bb.w);
      if (kInt) {
        const uint4 f = philox(static_cast<uint32_t>(r), kTagFlips, rk);
        uf[0] = unit23(f.x); uf[1] = unit23(f.y);
        uf[2] = unit23(f.z); uf[3] = unit23(f.w);
      }
    }
    float xv[4], yv[4];
    signed char fv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float z1, z2;
      gauss_pair<kNdtri>(u1[c], u2[c], z1, z2);
      float x = p.mu0 + p.sig0 * z1;
      float y = p.mu1 + p.sig1 * (rho * z1 + crho * z2);
      if (kNorm) {
        x = fminf(fmaxf(x, -p.l_clip), p.l_clip);
        y = fminf(fmaxf(y, -p.l_clip), p.l_clip);
        if (q[c] >= 0) {
          sum_x += x;
          sum_y += y;
        }
      }
      xv[c] = x;
      yv[c] = y;
      if (kInt) fv[c] = uf[c] < p.p_keep ? 1 : -1;
    }
    if (vec) {  // positions past n are padding that no later step reads
      *reinterpret_cast<float4*>(xs + o0) = make_float4(xv[0], xv[1], xv[2],
                                                        xv[3]);
      *reinterpret_cast<float4*>(ys + o0) = make_float4(yv[0], yv[1], yv[2],
                                                        yv[3]);
      if (kInt)
        *reinterpret_cast<char4*>(flips + o0) =
            make_char4(fv[0], fv[1], fv[2], fv[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (q[c] < 0) continue;
        xs[q[c]] = xv[c];
        ys[q[c]] = yv[c];
        if (kInt) flips[q[c]] = fv[c];
      }
    }
  }
  // batch noise 2/(m eps) * Laplace, two batches per Philox call; the
  // threads with one quad fewer take the second round
  for (int h = kThreads - 1 - tid; kNoiseSmem && 2 * h < p.k;
       h += kThreads) {
    float un[4];  // ux, uy of batch 2h, then of batch 2h + 1
    if (kExt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * h + i;
        const int r = j / p.g_cols;
        const int c = j - r * p.g_cols;
        un[2 * i] = j < p.k ? u[(row_noise + r) * kLanes + c] : 0.5f;
        un[2 * i + 1] =
            j < p.k ? u[(row_noise + p.rows + r) * kLanes + c] : 0.5f;
      }
    } else {
      const uint4 w = philox(static_cast<uint32_t>(h), kTagBatch, rk);
      un[0] = unit23(w.x);
      un[1] = unit23(w.y);
      un[2] = unit23(w.z);
      un[3] = unit23(w.w);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (2 * h + i < p.k)
        noise[2 * h + i] = make_float2(laplace1(un[2 * i]) * p.scale_x,
                                       laplace1(un[2 * i + 1]) * p.scale_y);
    }
  }
  if (kNorm) {
    sum_x = warp_sum(sum_x);
    sum_y = warp_sum(sum_y);
    if (lane == 0) {
      red[0][warp] = sum_x;
      red[1][warp] = sum_y;
    }
  }
  __syncthreads();  // publishes the planes, the noise, the scalar draws

  float mu_x = 0.f, mu_y = 0.f, mu_xi = 0.f, mu_yi = 0.f;
  if (kNorm) {
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sx += red[0][w];
      sy += red[1][w];
    }
    const float nf = static_cast<float>(n);
    mu_x = sx / nf + lap[0] * 2.0f * p.l_clip / p.den_x;
    mu_y = sy / nf + lap[1] * 2.0f * p.l_clip / p.den_y;
    mu_xi = sx / nf + lap[2] * 2.0f * p.l_clip / p.den_x;
    mu_yi = sy / nf + lap[3] * 2.0f * p.l_clip / p.den_y;
  }

  // ---- sweep: each lane reads four consecutive positions (one 16-byte
  // load per plane, 128 positions a warp: one chunk), so a batch of
  // m' <= 128 positions lies within one warp. Signs of a batch element are
  // packed as four byte counters (x > mu, x < mu, y > mu, y < mu), summed
  // over the lane's positions and then by xor shuffles over the m'/4 lanes
  // of the batch; the batch's first lane forms T_j. Counts stay <= m <=
  // 128, so the bytes never carry. At m' = 128 a warp takes two
  // consecutive chunks in turn, so the batches of one Philox call meet in
  // one warp.
  const int pos_shift = __ffs(mp) - 1;                 // log2 m'
  const int seg_lanes = mp >= 4 ? mp >> 2 : 1;         // lanes per batch
  const bool pair_chunks = !kNoiseSmem && mp == kLanes;
  float tot_t = 0.f, tot_t2 = 0.f;
  int core = 0;
  uint32_t carry_z = 0u, carry_w = 0u;  // m' = 128: batch 2h + 1's words
  for (int it = 0;; ++it) {
    const int chunk = pair_chunks
                          ? (it >> 1) * (2 * kWarps) + 2 * warp + (it & 1)
                          : it * kWarps + warp;
    const int base = chunk * kLanes;
    if (base >= end) break;          // warp-uniform
    const int q0 = base + 4 * lane;  // base + 128 <= plane: in bounds
    const float4 x4 = *reinterpret_cast<const float4*>(xs + q0);
    const float4 y4 = *reinterpret_cast<const float4*>(ys + q0);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
    uint32_t pk[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // bitwise, not branching, on the masks
      const int q = q0 + c;
      const bool elem = (q < kmp) & ((q & (mp - 1)) < m);
      pk[c] = static_cast<uint32_t>(elem & (xv[c] > mu_x)) |
              static_cast<uint32_t>(elem & (xv[c] < mu_x)) << 8 |
              static_cast<uint32_t>(elem & (yv[c] > mu_y)) << 16 |
              static_cast<uint32_t>(elem & (yv[c] < mu_y)) << 24;
    }
    if (kInt) {
      const char4 f4 = *reinterpret_cast<const char4*>(flips + q0);
      const int fv[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = q0 + c;
        const bool live = (q < end) & ((q >= kmp) | ((q & (mp - 1)) < m));
        core += (fv[c] * sign_of(xv[c], mu_xi) * sign_of(yv[c], mu_yi)) &
                -static_cast<int>(live);
      }
    }
    if (base >= kmp) continue;  // warp-uniform: leftovers only
    // the lane's batches j0 .. j0 + nb - 1: one (m' >= 4, in the batch's
    // first lane), two (m' = 2) or four (m' = 1)
    uint32_t cnt[4];
    int nb;
    if (mp >= 4) {
      cnt[0] = pk[0] + pk[1] + pk[2] + pk[3];
      for (int off = 1; off < seg_lanes; off <<= 1)
        cnt[0] += __shfl_xor_sync(kFull, cnt[0], off);
      nb = (lane & (seg_lanes - 1)) == 0 ? 1 : 0;
    } else if (mp == 2) {
      cnt[0] = pk[0] + pk[1];
      cnt[1] = pk[2] + pk[3];
      nb = 2;
    } else {
      cnt[0] = pk[0]; cnt[1] = pk[1]; cnt[2] = pk[2]; cnt[3] = pk[3];
      nb = 4;
    }
    const int j0 = q0 >> pos_shift;
    // noise kept out of shared memory: the (ux, uy) of the lane's batches,
    // from the same words pass 1 would have drawn
    float un[8];
    if (!kNoiseSmem) {
      if (kExt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + i;
          if (i >= nb || j >= p.k) break;
          const int r = j / p.g_cols;
          const int c = j - r * p.g_cols;
          un[2 * i] = u[(row_noise + r) * kLanes + c];
          un[2 * i + 1] = u[(row_noise + p.rows + r) * kLanes + c];
        }
      } else if (mp <= 2) {  // the lane's batches are whole calls
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * h >= nb || j0 + 2 * h >= p.k) break;
          const uint4 w = philox(static_cast<uint32_t>((j0 >> 1) + h),
                                 kTagBatch, rk);
          un[4 * h] = unit23(w.x);
          un[4 * h + 1] = unit23(w.y);
          un[4 * h + 2] = unit23(w.z);
          un[4 * h + 3] = unit23(w.w);
        }
      } else if (pair_chunks) {  // call h at chunk 2h, kept for 2h + 1
        if ((j0 & 1) == 0) {
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (nb == 1 && j0 < p.k)
            w = philox(static_cast<uint32_t>(j0 >> 1), kTagBatch, rk);
          un[0] = unit23(w.x);
          un[1] = unit23(w.y);
          carry_z = w.z;
          carry_w = w.w;
        } else {
          un[0] = unit23(carry_z);
          un[1] = unit23(carry_w);
        }
      } else {  // 4 <= m' <= 64: the call's first lane draws, the
                // other batch's lane takes z, w by a shuffle
        const int lead = lane & ~(2 * seg_lanes - 1);
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (lane == lead && j0 < p.k)
          w = philox(static_cast<uint32_t>(j0 >> 1), kTagBatch, rk);
        const uint32_t z = __shfl_sync(kFull, w.z, lead);
        const uint32_t ww = __shfl_sync(kFull, w.w, lead);
        un[0] = unit23(j0 & 1 ? z : w.x);
        un[1] = unit23(j0 & 1 ? ww : w.y);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= nb || j0 + i >= p.k) break;
      const uint32_t v = cnt[i];
      const int cx = static_cast<int>(v & 0xFFu) -
                     static_cast<int>((v >> 8) & 0xFFu);
      const int cy = static_cast<int>((v >> 16) & 0xFFu) -
                     static_cast<int>(v >> 24);
      const float2 nz =
          kNoiseSmem ? noise[j0 + i]
                     : make_float2(laplace1(un[2 * i]) * p.scale_x,
                                   laplace1(un[2 * i + 1]) * p.scale_y);
      const float xt = __fadd_rn(frac[cx + m], nz.x);
      const float yt = __fadd_rn(frac[cy + m], nz.y);
      const float t = mf * xt * yt;
      tot_t += t;
      tot_t2 += t * t;
    }
  }

  // ---- block sums
  tot_t = warp_sum(tot_t);
  tot_t2 = warp_sum(tot_t2);
  if (kInt) core = warp_sum(core);
  if (lane == 0) {
    red_t[0][warp] = tot_t;
    red_t[1][warp] = tot_t2;
    red_core[warp] = core;
  }
  __syncthreads();
  if (tid == 0) {
    float st = 0.f, st2 = 0.f;
    int cs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      st += red_t[0][w];
      st2 += red_t[1][w];
      cs += red_core[w];
    }
    out[3 * b + 0] = st;
    out[3 * b + 1] = st2;
    // |cs| <= n: exact in f32
    out[3 * b + 2] =
        kInt ? p.c_eta * static_cast<float>(cs) + lap[4] * p.scale_z : 0.f;
  }
}

// the planes: x and y (f32) and, with INT, one flip byte per position
size_t plane_bytes(const FusedNiParams& p, bool compute_int) {
  const size_t plane = static_cast<size_t>(p.rows) * kLanes;
  return plane * 2 * sizeof(float) + (compute_int ? plane : 0);
}

// whether the batch noise joins the planes in shared memory
bool noise_fits(const FusedNiParams& p, bool compute_int) {
  return plane_bytes(p, compute_int) + p.k * sizeof(float2) <= kSmemLimit;
}

// the variant of one mode for these parameters, and its dynamic shared
// memory, with the attributes set that let it take that much
template <bool kExt, bool kInt, bool kNdtri, bool kNorm>
cudaError_t prepare(const FusedNiParams& p, const void** kern,
                    size_t* smem) {
  const bool fits = noise_fits(p, kInt);
  *kern = fits ? reinterpret_cast<const void*>(
                     fused_ni_kernel<kExt, kInt, kNdtri, kNorm, true>)
               : reinterpret_cast<const void*>(
                     fused_ni_kernel<kExt, kInt, kNdtri, kNorm, false>);
  *smem = plane_bytes(p, kInt) + (fits ? p.k * sizeof(float2) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kExt, bool kInt, bool kNdtri, bool kNorm>
cudaError_t launch_one(const void* seeds, const void* rhos,
                       const void* uniforms, void* out, int batch,
                       const FusedNiParams& p, cudaStream_t stream) {
  const void* kern = nullptr;
  size_t smem = 0;
  cudaError_t err = prepare<kExt, kInt, kNdtri, kNorm>(p, &kern, &smem);
  if (err != cudaSuccess) return err;
  const auto* s = static_cast<const int2*>(seeds);
  const auto* r = static_cast<const float*>(rhos);
  const auto* u = static_cast<const float*>(uniforms);
  auto* o = static_cast<float*>(out);
  if (noise_fits(p, kInt))
    fused_ni_kernel<kExt, kInt, kNdtri, kNorm, true>
        <<<batch, kThreads, smem, stream>>>(s, r, u, o, p);
  else
    fused_ni_kernel<kExt, kInt, kNdtri, kNorm, false>
        <<<batch, kThreads, smem, stream>>>(s, r, u, o, p);
  return cudaGetLastError();
}

template <bool kExt, bool kInt, bool kNdtri, bool kNorm>
cudaError_t blocks_one(const FusedNiParams& p, int* blocks) {
  const void* kern = nullptr;
  size_t smem = 0;
  cudaError_t err = prepare<kExt, kInt, kNdtri, kNorm>(p, &kern, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                       kThreads, smem);
}

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, int, const FusedNiParams&,
                                 cudaStream_t);
using BlocksFn = cudaError_t (*)(const FusedNiParams&, int*);

// index = external*8 + compute_int*4 + ndtri*2 + normalise
#define FUSED_NI_MODES(fn)                                                  \
  {fn<false, false, false, false>, fn<false, false, false, true>,           \
   fn<false, false, true, false>,  fn<false, false, true, true>,            \
   fn<false, true, false, false>,  fn<false, true, false, true>,            \
   fn<false, true, true, false>,   fn<false, true, true, true>,             \
   fn<true, false, false, false>,  fn<true, false, false, true>,            \
   fn<true, false, true, false>,   fn<true, false, true, true>,             \
   fn<true, true, false, false>,   fn<true, true, false, true>,             \
   fn<true, true, true, false>,    fn<true, true, true, true>}

const LaunchFn kLaunch[16] = FUSED_NI_MODES(launch_one);
const BlocksFn kBlocks[16] = FUSED_NI_MODES(blocks_one);

int mode_index(int external, int compute_int, int ndtri, int normalise) {
  return (external ? 8 : 0) + (compute_int ? 4 : 0) + (ndtri ? 2 : 0) +
         (normalise ? 1 : 0);
}

}  // namespace

extern "C" {

// Launches one block per replication on `stream`; returns cudaGetLastError()
// of the launch (0 on success). `uniforms` is read only when `external`.
int fused_ni_launch(const void* seeds, const void* rhos, const void* uniforms,
                    void* out, int batch, const FusedNiParams* params,
                    int external, int compute_int, int ndtri, int normalise,
                    void* stream) {
  if (batch <= 0) return 0;
  const int idx = mode_index(external, compute_int, ndtri, normalise);
  return static_cast<int>(kLaunch[idx](seeds, rhos, uniforms, out, batch,
                                       *params,
                                       static_cast<cudaStream_t>(stream)));
}

// Blocks of one mode that the card keeps resident on one SM at these
// parameters, into *blocks; returns the CUDA error code (0 on success).
int fused_ni_blocks_per_sm(const FusedNiParams* params, int external,
                           int compute_int, int ndtri, int normalise,
                           int* blocks) {
  const int idx = mode_index(external, compute_int, ndtri, normalise);
  return static_cast<int>(kBlocks[idx](*params, blocks));
}

const char* fused_ni_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
