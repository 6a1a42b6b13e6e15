// Fused NI/INT sign-batch replication kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of dpcorr/ops/pallas_ni.py: the inner `kernel`
// built by `_make_kernel` and launched by `_replication_call` (callers
// `_ni_sign_pallas_sums`, `ni_sign_pallas`, `sim_detail_pallas`). One
// thread block computes one whole Monte-Carlo replication of the
// north-star workload (vert-cor.R:392-419):
//
//   pass 1  draw n Gaussian pairs (Box-Muller, or Acklam's inverse CDF),
//           apply the 2x2 Cholesky factor with the replication's rho, clip
//           at +-sqrt(2 ln n), keep x and y in shared memory and
//           block-reduce the masked sums of the clipped values;
//   scalar  DP means: sum/n + Laplace * 2L/(n eps/2) (vert-cor.R:322-348);
//   pass 2  per batch j < k: sign sums over its m elements (a segmented
//           reduction, one batch per thread; no matmul against the TPU
//           kernel's 0/1 matrix G), per-batch Laplace 2/(m eps),
//           T_j = m X~_j Y~_j, and block sums of T_j and T_j^2;
//   pass 3  (INT) randomized response on the same draw with its own DP
//           centering and one receiver Laplace term -> eta_INT.
//
// Output: out[b] = (sum T_j, sum T_j^2, eta_INT), f32. The scalar CI
// epilogue runs in PyTorch (dpcorr_torch/ops/fused_ni.py).
//
// Positions follow the TPU kernel's padded lane-group layout
// (pallas_ni.py `_layout`, `_position_masks`): position q = row*128 + lane
// holds batch element (q / m', q % m' < m) for q < k*m', a leftover
// observation for k*m' <= q < k*m' + leftover, else padding. Two uniform
// sources, both compile-time:
//   external  (B, u_rows, 128) f32 uniforms read in the TPU kernel's
//             take() order (u1, u2, 8 centering rows if normalise,
//             2*rows of batch noise, then with INT 8 rows and `rows` flip
//             rows), so the kernel can be held against its plain PyTorch
//             version (dpcorr_torch/ops/fused_ni.py) on identical inputs;
//   in-kernel Philox4x32-10 keyed by the replication's two seed words.
//             Counter (q, 0) gives u1, u2 and the flip uniform of
//             position q; (j, 1) the two noise draws of batch j; (0, 2)
//             and (1, 2) the centering and receiver draws. Only live
//             draws are made (2k batch draws plus scalars, not the TPU
//             kernel's 2*rows*128 tiling planes): distribution-identical.
// Bits become uniforms by the TPU kernel's 23-bit rule (`_uniform`):
// u = (b23 + 0.5) 2^-23 in [2^-24, 1 - 2^-24], so log and log1p stay finite.
//
// What bounds it on this card: in-kernel mode reads 12 bytes (two seed
// words, rho) and writes 12 bytes per replication, so the bound is
// arithmetic: per position one Philox4x32-10 call (10 rounds of two
// 32-bit multiply-high/low pairs and xors) plus log, sqrt, sin and cos
// (or the two rational polynomials of the inverse CDF), the Cholesky
// step and clip; per batch m sign tests of each column. Its design keeps
// every per-position value on chip: the planes live in shared memory
// (2 x 4 B + 1 B per position, 90 KB at n = 10^4, two blocks per SM), so
// device memory carries only the 24 B per replication, and each
// transcendental is evaluated once per position.
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
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 23-bit rule of pallas_ni.py `_uniform`.
__device__ __forceinline__ float unit23(uint32_t bits) {
  return (static_cast<float>((bits >> 9) & 0x7FFFFFu) + 0.5f) *
         1.1920928955078125e-07f;
}

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ int sign_i(float v) {
  return (v > 0.f) - (v < 0.f);
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

// Sums each of v[0..N) over the block; every thread gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_xor_sync(0xFFFFFFFFu, v[i], off);
    if (lane == 0) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = lane < kWarps ? red[i * kWarps + lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      if (lane == 0) red[i * kWarps] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = red[i * kWarps];
  __syncthreads();
}

template <bool kExt, bool kInt, bool kNdtri, bool kNorm>
__global__ void __launch_bounds__(kThreads)
    fused_ni_kernel(const int2* __restrict__ seeds,
                    const float* __restrict__ rhos,
                    const float* __restrict__ uniforms,
                    float* __restrict__ out, const FusedNiParams p) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];
  const int plane = p.rows * kLanes;
  float* xs = smem;
  float* ys = smem + plane;
  signed char* flips = reinterpret_cast<signed char*>(smem + 2 * plane);

  const int b = blockIdx.x;
  const float rho = rhos[b];
  const float crho = sqrtf(1.0f - rho * rho);
  const float* u =
      kExt ? uniforms + static_cast<size_t>(b) * p.u_rows * kLanes : nullptr;
  const int2 sd = seeds[b];
  const uint2 key = make_uint2(static_cast<uint32_t>(sd.x),
                               static_cast<uint32_t>(sd.y));
  const int kmp = p.k * p.m_pad;
  const int end = kmp + p.leftover;
  // row offsets of each draw in an external block (the take() order)
  const int row_std = 2 * p.rows;
  const int row_noise = kNorm ? row_std + 8 : row_std;
  const int row_int = row_noise + 2 * p.rows;
  const int row_flip = row_int + 8;

  // ---- pass 1: generate, keep on chip, sum the clipped values
  float sums[2] = {0.f, 0.f};
  for (int q = threadIdx.x; q < end; q += kThreads) {
    if (q < kmp && (q & (p.m_pad - 1)) >= p.m) continue;  // padding lane
    float u1, u2, uf = 0.f;
    if (kExt) {
      u1 = u[q];
      u2 = u[plane + q];
      if (kInt) uf = u[row_flip * kLanes + q];
    } else {
      const uint4 r = philox4x32_10(make_uint4(q, 0u, 0u, 0u), key);
      u1 = unit23(r.x);
      u2 = unit23(r.y);
      uf = unit23(r.z);
    }
    float z1, z2;
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
    float x = p.mu0 + p.sig0 * z1;
    float y = p.mu1 + p.sig1 * (rho * z1 + crho * z2);
    if (kNorm) {
      x = fminf(fmaxf(x, -p.l_clip), p.l_clip);
      y = fminf(fmaxf(y, -p.l_clip), p.l_clip);
      sums[0] += x;
      sums[1] += y;
    }
    xs[q] = x;
    ys[q] = y;
    if (kInt) flips[q] = uf < p.p_keep ? 1 : -1;
  }
  block_sum<2>(sums, red);  // also publishes xs/ys/flips to the block

  // ---- scalar draws: centering noise (NI, INT) and the receiver term
  float lx = 0.f, ly = 0.f, lxi = 0.f, lyi = 0.f, uz = 0.5f;
  if (kExt) {
    if (kNorm) {
      lx = laplace1(u[row_std * kLanes]);
      ly = laplace1(u[(row_std + 1) * kLanes]);
    }
    if (kInt) {
      lxi = laplace1(u[row_int * kLanes]);
      lyi = laplace1(u[(row_int + 1) * kLanes]);
      uz = u[(row_int + 2) * kLanes];
    }
  } else {
    const uint4 r = philox4x32_10(make_uint4(0u, 2u, 0u, 0u), key);
    lx = laplace1(unit23(r.x));
    ly = laplace1(unit23(r.y));
    lxi = laplace1(unit23(r.z));
    lyi = laplace1(unit23(r.w));
    if (kInt) uz = unit23(philox4x32_10(make_uint4(1u, 2u, 0u, 0u), key).x);
  }
  const float nf = static_cast<float>(p.n);
  float mu_x = 0.f, mu_y = 0.f, mu_xi = 0.f, mu_yi = 0.f;
  if (kNorm) {
    mu_x = sums[0] / nf + lx * 2.0f * p.l_clip / p.den_x;
    mu_y = sums[1] / nf + ly * 2.0f * p.l_clip / p.den_y;
    mu_xi = sums[0] / nf + lxi * 2.0f * p.l_clip / p.den_x;
    mu_yi = sums[1] / nf + lyi * 2.0f * p.l_clip / p.den_y;
  }

  // ---- pass 2: sign batch sums, batch noise, T_j
  float tot[3] = {0.f, 0.f, 0.f};
  const float mf = static_cast<float>(p.m);
  for (int j = threadIdx.x; j < p.k; j += kThreads) {
    const int base = j * p.m_pad;
    int cx = 0, cy = 0;
    for (int i = 0; i < p.m; ++i) {
      cx += sign_i(xs[base + i] - mu_x);
      cy += sign_i(ys[base + i] - mu_y);
    }
    float ux, uy;
    if (kExt) {
      const int r = j / p.g_cols;
      const int c = j - r * p.g_cols;
      ux = u[(row_noise + r) * kLanes + c];
      uy = u[(row_noise + p.rows + r) * kLanes + c];
    } else {
      const uint4 r = philox4x32_10(make_uint4(j, 1u, 0u, 0u), key);
      ux = unit23(r.x);
      uy = unit23(r.y);
    }
    const float xt = static_cast<float>(cx) / mf + laplace1(ux) * p.scale_x;
    const float yt = static_cast<float>(cy) / mf + laplace1(uy) * p.scale_y;
    const float t = mf * xt * yt;
    tot[0] += t;
    tot[1] += t * t;
  }

  // ---- pass 3 (INT): randomized response over all n observations
  if (kInt) {
    int core = 0;
    for (int q = threadIdx.x; q < end; q += kThreads) {
      if (q < kmp && (q & (p.m_pad - 1)) >= p.m) continue;
      core += flips[q] * sign_i(xs[q] - mu_xi) * sign_i(ys[q] - mu_yi);
    }
    tot[2] = static_cast<float>(core);  // |core| <= n: exact in f32
  }
  block_sum<3>(tot, red);

  if (threadIdx.x == 0) {
    out[3 * b + 0] = tot[0];
    out[3 * b + 1] = tot[1];
    out[3 * b + 2] = kInt ? p.c_eta * tot[2] + laplace1(uz) * p.scale_z : 0.f;
  }
}

size_t smem_bytes(const FusedNiParams& p, bool compute_int) {
  const size_t plane = static_cast<size_t>(p.rows) * kLanes;
  return plane * 2 * sizeof(float) + (compute_int ? plane : 0);
}

template <bool kExt, bool kInt, bool kNdtri, bool kNorm>
cudaError_t launch_one(const void* seeds, const void* rhos,
                       const void* uniforms, void* out, int batch,
                       const FusedNiParams& p, cudaStream_t stream) {
  auto kern = fused_ni_kernel<kExt, kInt, kNdtri, kNorm>;
  const size_t smem = smem_bytes(p, kInt);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<batch, kThreads, smem, stream>>>(
      static_cast<const int2*>(seeds), static_cast<const float*>(rhos),
      static_cast<const float*>(uniforms), static_cast<float*>(out), p);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, int, const FusedNiParams&,
                                 cudaStream_t);

// index = external*8 + compute_int*4 + ndtri*2 + normalise
const LaunchFn kLaunch[16] = {
    launch_one<false, false, false, false>, launch_one<false, false, false, true>,
    launch_one<false, false, true, false>,  launch_one<false, false, true, true>,
    launch_one<false, true, false, false>,  launch_one<false, true, false, true>,
    launch_one<false, true, true, false>,   launch_one<false, true, true, true>,
    launch_one<true, false, false, false>,  launch_one<true, false, false, true>,
    launch_one<true, false, true, false>,   launch_one<true, false, true, true>,
    launch_one<true, true, false, false>,   launch_one<true, true, false, true>,
    launch_one<true, true, true, false>,    launch_one<true, true, true, true>,
};

}  // namespace

extern "C" {

// Launches one block per replication on `stream`; returns cudaGetLastError()
// of the launch (0 on success). `uniforms` is read only when `external`.
int fused_ni_launch(const void* seeds, const void* rhos, const void* uniforms,
                    void* out, int batch, const FusedNiParams* params,
                    int external, int compute_int, int ndtri, int normalise,
                    void* stream) {
  if (batch <= 0) return 0;
  const int idx = (external ? 8 : 0) + (compute_int ? 4 : 0) +
                  (ndtri ? 2 : 0) + (normalise ? 1 : 0);
  return static_cast<int>(kLaunch[idx](seeds, rhos, uniforms, out, batch,
                                       *params,
                                       static_cast<cudaStream_t>(stream)));
}

const char* fused_ni_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
