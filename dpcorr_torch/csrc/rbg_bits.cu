// XLA's Philox bit generator for the key-tree's rbg-family keys, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port of `lax.rng_bit_generator`,
// the XLA operation `jax.random.bits` reaches on a key of the `rbg` and
// `unsafe_rbg` implementations (jax/_src/prng.py `_rbg_random_bits`,
// `_unsafe_rbg_split`, `_unsafe_rbg_fold_in`), which the JAX package
// selects with `master_key(impl=...)` or DPCORR_PRNG
// (dpcorr/utils/rng.py:32-45). No PyTorch call computes this layout.
//
// What it computes, for key words (w0, w1, w2, w3) of each of K keys:
// Philox4x32-10 keyed by (w0, w1) on the 128-bit counter whose
// little-endian 32-bit words start at (w2, w3, w0, w1); the counter of
// Philox block b is that start plus `offset + b * stride`, with the carry
// across all 128 bits. Output word j of a key is word j % 4 of its block
// j / 4, for j < n_words (the last block's words past n_words are not
// written). With offset 0 and stride 1 this is XLA's default generator
// (RNG_DEFAULT = RNG_PHILOX on the CPU) on a row-major output;
// unsafe_rbg's fold_in takes block 9 (offset 9) and its split every
// tenth block (stride 10).
//
// Output: int64 holding each uint32 word, the port's convention for
// key-tree words (dpcorr_torch/utils/rng.py), row-major (K, n_words).
//
// What bounds it on this card: each word is written as 8 bytes, against
// about 12 int32 operations a word for Philox (10 rounds of two 32x32->64
// multiplies and two three-input xors per four words, and the counter's
// 128-bit add), so at the main shape it is bound by device-memory bytes
// (3.35 TB/s), not by the integer pipe. What the design does about it:
//   1. one thread per Philox block, the blocks of one key along x and the
//      keys along y of the grid (grid-stride loops both ways), so no
//      thread divides a 64-bit index;
//   2. the stores are coalesced: the four words of a thread's block are
//      passed through the warp by shuffles, so that each store
//      instruction writes 32 consecutive words (256 bytes) of the key's
//      row, where the four int64 stores of each thread would each touch
//      every sector of the warp's kilobyte;
//   3. the key's words and the counter's start are loaded once per row.
// Writing uint32 would halve the bytes; the port keeps int64 words
// throughout, so that is left to a later change of the convention.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Grid: x over a key's Philox blocks, y over the keys; blockDim.x a
// multiple of 32 (every lane takes part in the shuffles).
__global__ void __launch_bounds__(kThreads)
rbg_bits_kernel(const long long* __restrict__ keys,
                long long* __restrict__ out, long long n_keys,
                long long n_words, unsigned long long offset,
                unsigned long long stride) {
  const long long per_key = (n_words + 3) / 4;
  const int lane = threadIdx.x & 31;
  for (long long r = blockIdx.y; r < n_keys; r += gridDim.y) {
    const long long* kw = keys + 4 * r;
    const uint32_t w0 = static_cast<uint32_t>(kw[0]);
    const uint32_t w1 = static_cast<uint32_t>(kw[1]);
    const unsigned long long lo0 =
        (static_cast<unsigned long long>(static_cast<uint32_t>(kw[3]))
         << 32) | static_cast<uint32_t>(kw[2]);
    const unsigned long long hi0 =
        (static_cast<unsigned long long>(w1) << 32) | w0;
    long long* row = out + r * n_words;
    // the loop's bound is the same for the whole thread block, so every
    // lane reaches the shuffles; blocks past the row are drawn, not stored
    for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
         base < per_key;
         base += static_cast<long long>(gridDim.x) * blockDim.x) {
      const unsigned long long b =
          static_cast<unsigned long long>(base + threadIdx.x);
      // 128-bit counter: low half (w2, w3), high half (w0, w1), plus the
      // block's index, the carry taken into the high half
      const unsigned long long lo = lo0 + (offset + b * stride);
      const unsigned long long hi = hi0 + (lo < lo0 ? 1ull : 0ull);
      const uint4 c = philox10(
          make_uint4(static_cast<uint32_t>(lo),
                     static_cast<uint32_t>(lo >> 32),
                     static_cast<uint32_t>(hi),
                     static_cast<uint32_t>(hi >> 32)),
          w0, w1);
      // the warp's 32 blocks are the row's words first .. first + 127;
      // store j writes words j*32 .. j*32 + 31 of them, word p from
      // component p % 4 of lane p / 4
      const long long first = 4 * (base + (threadIdx.x & ~31));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = j * 32 + lane;
        const int src = p >> 2;
        const uint32_t x = __shfl_sync(0xFFFFFFFFu, c.x, src);
        const uint32_t y = __shfl_sync(0xFFFFFFFFu, c.y, src);
        const uint32_t z = __shfl_sync(0xFFFFFFFFu, c.z, src);
        const uint32_t w = __shfl_sync(0xFFFFFFFFu, c.w, src);
        const int comp = p & 3;
        const uint32_t v = comp == 0 ? x : comp == 1 ? y : comp == 2 ? z : w;
        if (first + p < n_words) row[first + p] = static_cast<long long>(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// Writes (n_keys, n_words) int64 words into `out` on `stream`; returns
// cudaGetLastError() of the launch (0 on success). `keys` is (n_keys, 4)
// int64 holding uint32 words.
int rbg_bits_launch(const void* keys, void* out, long long n_keys,
                    long long n_words, long long offset, long long stride,
                    void* stream) {
  if (n_keys <= 0 || n_words <= 0) return 0;
  const long long per_key = (n_words + 3) / 4;
  // a short row takes a narrow block (whole warps), a long one kThreads
  const int threads = static_cast<int>(
      per_key >= kThreads ? kThreads : (per_key + 31) / 32 * 32);
  long long grid_x = (per_key + threads - 1) / threads;
  if (grid_x > 132 * 8) grid_x = 132 * 8;  // the loops do the rest
  const long long grid_y = n_keys < 65535 ? n_keys : 65535;
  rbg_bits_kernel<<<dim3(static_cast<unsigned>(grid_x),
                         static_cast<unsigned>(grid_y)),
                    threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<long long*>(out),
      n_keys, n_words, static_cast<unsigned long long>(offset),
      static_cast<unsigned long long>(stride));
  return static_cast<int>(cudaGetLastError());
}

const char* rbg_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
