// Stage ladder of the fused NI kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel K2 of benchmarks/pallas_bisect.py: the inner
// `kernel` of `probe_level` (:100), launched by its `pl.pallas_call`
// (:162). That harness built the fused kernel K1 (dpcorr/ops/pallas_ni.py)
// up one feature per level to find which one hung the TPU's compiler; on
// this card the same ladder splits K1's time into its stages. One thread
// block computes one replication's `acc` at level kLevel (the traced
// constant `want` + 1), summed over the positions q in [0, rows * 128) of
// the padded lane-group layout (fused_ni.py `layout`):
//
//   L1 prng       sum of bits1 and bits2 as signed int32 -> f32;
//   L2 boxmuller  + the 23-bit uniforms and Box-Muller; sum z1 + sum z2;
//   L3 genmask    + x = z1, y = rho z1 + sqrt(1 - rho^2) z2 and the weight
//                 w (batch element or leftover); sum x w + sum y w;
//   L4 center     + clip at +-sqrt(2 ln n), the DP means
//                 sum(vc w) / n + Laplace * 2L / (n eps / 2) with the
//                 Laplace draws at rows 2*rows and 2*rows + 1, lane 0; the
//                 clipped planes kept in shared memory, as K1 keeps them,
//                 and swept: sum x_c w + sum y_c w; where the planes do
//                 not fit (n above 28,672 at m = 8), the variant without
//                 them (kPlanes = false) draws each position again in the
//                 sweep, as K1's variant without planes does;
//   L5 matmul     + the signs of batch elements summed per batch as K1's
//                 sweep sums them (packed byte counts, xor shuffles; the
//                 TPU's matmul against its 0/1 matrix, without the
//                 matrix): sum_j (cx_j + cy_j) / m.
// L6 and L7 are K1 itself (csrc/fused_ni.cu). Output: out[b] = acc, f32,
// written by the block's first thread, so no stage can be dropped.
//
// Two bit sources, both compile-time:
//   external  (B, 2*rows + 8, 128) int32 bits in the JAX ladder's call
//             order: bits1, bits2, then 8 rows for the Laplace draws, so
//             the kernel can be held against its plain PyTorch version
//             (dpcorr_torch/ops/ladder.py) on identical inputs;
//   in-kernel K1's Philox4x32-10 on the replication's seed words: position
//             q takes words (x, y) or (z, w) of counter (q / 2, 0, 0, 0),
//             K1's draw of observation q wherever position and observation
//             coincide (m a power of two, as on the main path), and the
//             Laplace draws words x, y of counter (0, 3, 0, 0), K1's
//             centering draws. `philox_bits` in ops/ladder.py lays the same
//             words out in external order, so external mode on its output
//             gives this mode's results bit for bit.
//
// What bounds it on this card: in-kernel mode moves 12 bytes per
// replication, so each level is bound by its arithmetic, from L2 on by
// the 32-bit integer pipe (Philox), as K1 is (utils/roofline.py
// `ladder_pipe_ops` counts each level's work by pipe). The design keeps
// each level a prefix of K1's: K1's Philox, uniforms, Box-Muller and
// pinned Cholesky rounding, its 512 threads with four positions a thread
// and step, its planes in shared memory from L4 on (or none, above the
// cap), its segmented sign sums in L5, all from the device functions the
// two kernels share (fused_ni_common.cuh); so the increment from one
// level to the next is what that stage costs inside K1. It is a
// diagnostic: the main path never runs it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (dpcorr_torch/ops/_build.py). No fast-math.

#include "fused_ni_common.cuh"

extern "C" {
// Mirrored by the ctypes Structure in dpcorr_torch/ops/ladder.py: six
// ints, then four floats, no padding.
struct LadderParams {
  int n, m, m_pad, k, leftover, rows;
  float rho, l_clip, den_x, den_y;
};
}

namespace {

// the block's two sums, reduced in a fixed order; every thread gets them
__device__ __forceinline__ float2 block_sum(float a, float b,
                                            float (*red)[kWarps]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    sa += red[0][w];
    sb += red[1][w];
  }
  return make_float2(sa, sb);
}

// kPlanes (L4-L5): the clipped x and y are kept in shared memory for the
// sweep; else the sweep draws them again from the same bits
template <int kLevel, bool kExt, bool kPlanes>
__global__ void __launch_bounds__(kThreads, 2)
    ladder_kernel(const int2* __restrict__ seeds,
                  const int* __restrict__ bits, float* __restrict__ out,
                  const LadderParams p) {
  static_assert(kLevel >= 1 && kLevel <= 5, "levels 1-5; L6-L7 are K1");
  static_assert(!kPlanes || kLevel >= 4, "planes are kept from L4 on");
  extern __shared__ __align__(16) unsigned char smem[];
  // the first sums (read by every thread), then the sweep's
  __shared__ float red[2][kWarps];
  __shared__ float red_sweep[2][kWarps];
  __shared__ float lap[2];
  __shared__ float frac[2 * kLanes + 1];  // c / m for c = -m .. m
  const int plane = p.rows * kLanes;
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + plane;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int* bb =
      kExt ? bits + static_cast<size_t>(b) * (2 * p.rows + 8) * kLanes
           : nullptr;
  const RoundKeys rk = round_keys(seeds[b]);
  const int m = p.m, mp = p.m_pad;
  const int kmp = p.k * mp;
  const int end = kmp + p.leftover;
  const float rho = p.rho;
  const float crho = cholesky_c(rho);
  const float mf = static_cast<float>(m);

  // the bits of positions q0 .. q0 + 3 (q0 a multiple of 4)
  auto words = [&](int q0, uint32_t* w1, uint32_t* w2) {
    if (kExt) {
      const int4 a = *reinterpret_cast<const int4*>(bb + q0);
      const int4 c = *reinterpret_cast<const int4*>(bb + plane + q0);
      w1[0] = a.x; w1[1] = a.y; w1[2] = a.z; w1[3] = a.w;
      w2[0] = c.x; w2[1] = c.y; w2[2] = c.z; w2[3] = c.w;
    } else {
      quad_words(static_cast<uint32_t>(q0 >> 2), rk, w1, w2);
    }
  };
  // x and y at one position from its Gaussian pair, clipped from L4 on
  auto place = [&](float z1, float z2, float& x, float& y) {
    x = z1;
    y = correlate(rho, crho, z1, z2);
    if (kLevel >= 4) {
      x = fminf(fmaxf(x, -p.l_clip), p.l_clip);
      y = fminf(fmaxf(y, -p.l_clip), p.l_clip);
    }
  };
  // x and y of positions q0 .. q0 + 3: from the planes, or drawn again
  auto planes_at = [&](int q0, float* xv, float* yv) {
    if (kPlanes) {
      const float4 x4 = *reinterpret_cast<const float4*>(xs + q0);
      const float4 y4 = *reinterpret_cast<const float4*>(ys + q0);
      xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
      yv[0] = y4.x; yv[1] = y4.y; yv[2] = y4.z; yv[3] = y4.w;
    } else {
      uint32_t w1[4], w2[4];
      words(q0, w1, w2);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float z1, z2;
        gauss_pair<false>(unit23(w1[c]), unit23(w2[c]), z1, z2);
        place(z1, z2, xv[c], yv[c]);
      }
    }
  };
  // batch element or leftover
  auto weight = [&](int q) {
    return (q < end) & ((q >= kmp) | ((q & (mp - 1)) < m));
  };

  if (kLevel >= 5)
    for (int i = tid; i <= 2 * m; i += kThreads)
      frac[i] = static_cast<float>(i - m) / mf;
  if (kLevel >= 4 && tid == 0) {
    uint32_t wx, wy;
    if (kExt) {
      wx = static_cast<uint32_t>(bb[2 * plane]);
      wy = static_cast<uint32_t>(bb[2 * plane + kLanes]);
    } else {
      const uint4 r = philox(0u, kTagScalar, rk);
      wx = r.x;
      wy = r.y;
    }
    lap[0] = laplace1(unit23(wx));
    lap[1] = laplace1(unit23(wy));
  }

  // ---- pass 1: four positions per thread and step
  float s1 = 0.f, s2 = 0.f;
  const int quads = plane >> 2;
  for (int r = tid; r < quads; r += kThreads) {
    const int q0 = 4 * r;
    uint32_t w1[4], w2[4];
    words(q0, w1, w2);
    float xv[4], yv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kLevel == 1) {
        s1 += static_cast<float>(static_cast<int>(w1[c]));
        s2 += static_cast<float>(static_cast<int>(w2[c]));
        continue;
      }
      float z1, z2;
      gauss_pair<false>(unit23(w1[c]), unit23(w2[c]), z1, z2);
      if (kLevel == 2) {
        s1 += z1;
        s2 += z2;
        continue;
      }
      place(z1, z2, xv[c], yv[c]);
      if (weight(q0 + c)) {
        s1 += xv[c];
        s2 += yv[c];
      }
    }
    if (kPlanes) {
      *reinterpret_cast<float4*>(xs + q0) =
          make_float4(xv[0], xv[1], xv[2], xv[3]);
      *reinterpret_cast<float4*>(ys + q0) =
          make_float4(yv[0], yv[1], yv[2], yv[3]);
    }
  }
  // publishes the planes and the Laplace draws too
  const float2 first = block_sum(s1, s2, red);
  if (kLevel <= 3) {
    if (tid == 0) out[b] = first.x + first.y;
    return;
  }

  const float nf = static_cast<float>(p.n);
  const float mu_x = first.x / nf + lap[0] * 2.0f * p.l_clip / p.den_x;
  const float mu_y = first.y / nf + lap[1] * 2.0f * p.l_clip / p.den_y;
  float t1 = 0.f, t2 = 0.f;
  if (kLevel == 4) {  // the centered values, weighted, in pass 1's order
    for (int r = tid; r < quads; r += kThreads) {
      const int q0 = 4 * r;
      float xv[4], yv[4];
      planes_at(q0, xv, yv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (weight(q0 + c)) {
          t1 += xv[c] - mu_x;
          t2 += yv[c] - mu_y;
        }
      }
    }
  } else {  // the sign sweep of K1, four positions a lane, 128 a warp
    const int pos_shift = __ffs(mp) - 1;  // log2 m'
    for (int chunk = warp;; chunk += kWarps) {
      const int base = chunk * kLanes;
      if (base >= kmp) break;  // warp-uniform: batch elements only
      const int q0 = base + 4 * lane;
      float xv[4], yv[4];
      planes_at(q0, xv, yv);
      uint32_t pk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = q0 + c;
        pk[c] = sign_bytes((q < kmp) & ((q & (mp - 1)) < m), xv[c], yv[c],
                           mu_x, mu_y);
      }
      uint32_t cnt[4];
      const int nb = batch_counts(pk, mp, lane, cnt);
      const int j0 = q0 >> pos_shift;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= nb || j0 + i >= p.k) break;
        const int2 cc = count_pair(cnt[i]);
        t1 += frac[cc.x + m];
        t2 += frac[cc.y + m];
      }
    }
  }
  const float2 sweep = block_sum(t1, t2, red_sweep);
  if (tid == 0) out[b] = sweep.x + sweep.y;
}

// the planes L4 and L5 keep in shared memory where they fit: x and y, f32
size_t plane_bytes(const LadderParams& p) {
  return static_cast<size_t>(p.rows) * kLanes * 2 * sizeof(float);
}

template <int kLevel, bool kExt, bool kPlanes>
cudaError_t start(const void* seeds, const void* bits, void* out, int batch,
                  const LadderParams& p, cudaStream_t stream) {
  const size_t smem = kPlanes ? plane_bytes(p) : 0;
  const void* kern =
      reinterpret_cast<const void*>(ladder_kernel<kLevel, kExt, kPlanes>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ladder_kernel<kLevel, kExt, kPlanes><<<batch, kThreads, smem, stream>>>(
      static_cast<const int2*>(seeds), static_cast<const int*>(bits),
      static_cast<float*>(out), p);
  return cudaGetLastError();
}

// L4-L5 keep the planes where they fit, unless `regen` asks for the
// variant without them
template <int kLevel, bool kExt>
cudaError_t launch_one(const void* seeds, const void* bits, void* out,
                       int batch, const LadderParams& p, bool regen,
                       cudaStream_t stream) {
  if constexpr (kLevel >= 4) {
    if (!regen && plane_bytes(p) <= kSmemLimit)
      return start<kLevel, kExt, true>(seeds, bits, out, batch, p, stream);
  }
  return start<kLevel, kExt, false>(seeds, bits, out, batch, p, stream);
}

using LaunchFn = cudaError_t (*)(const void*, const void*, void*, int,
                                 const LadderParams&, bool, cudaStream_t);

// index = (level - 1) * 2 + external
const LaunchFn kLaunch[10] = {
    launch_one<1, false>, launch_one<1, true>, launch_one<2, false>,
    launch_one<2, true>,  launch_one<3, false>, launch_one<3, true>,
    launch_one<4, false>, launch_one<4, true>,  launch_one<5, false>,
    launch_one<5, true>};

}  // namespace

extern "C" {

// Launches one block per replication at `level` (1-5) on `stream`;
// returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for a level out of range. `bits` is read only
// when `external`. L4-L5 keep their planes in shared memory where they
// fit, and draw each position again elsewhere or where `regen` asks.
int ladder_launch(const void* seeds, const void* bits, void* out, int batch,
                  const LadderParams* params, int level, int external,
                  int regen, void* stream) {
  if (level < 1 || level > 5) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  return static_cast<int>(kLaunch[(level - 1) * 2 + (external ? 1 : 0)](
      seeds, bits, out, batch, *params, regen != 0,
      static_cast<cudaStream_t>(stream)));
}

const char* ladder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
