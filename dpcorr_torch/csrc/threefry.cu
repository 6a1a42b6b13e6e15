// Threefry-2x32 (20 rounds) for the key-tree's threefry2x32 keys, and
// the f32 uniforms drawn from its words, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the hash `jax.random` evaluates for
// every threefry2x32 key (`threefry_2x32` in jax/_src/prng.py, integer
// ops under XLA), which the port's key-tree (dpcorr_torch/utils/rng.py)
// ran as about a hundred int64 torch ops, each a pass over device memory,
// and `jax.random.uniform`'s map of the words to f32 (XLA integer and
// float ops), which it ran as about ten int64 and f64 torch ops over the
// words. No PyTorch call computes either.
//
// What it computes, for key words (k0, k1) and counter words (x0, x1):
// the Threefry-2x32 block cipher of Random123 with 20 rounds, key
// schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), rotations (13, 15, 26, 6) and
// (17, 29, 16, 24) in turns, a key injection after every four rounds.
// Three entry points share the one round function:
//   threefry_bits_launch: keys (K, 2) -> (K, n_words); word i of key k is
//     y0 ^ y1 of threefry(key_k, (i >> 32, i & 0xFFFFFFFF)), the
//     partitionable counter layout of `jax.random.bits`;
//   threefry_uniform_launch: keys (K, 2), lo, span -> (K, n_words) f32:
//     the same word w, mapped as `jax.random.uniform` maps it and as the
//     port's plain path computes it: f = float bits ((w >> 9) |
//     0x3F800000) - 1 in [0, 1), u = f32(f64(f) * span + lo) rounded
//     once to f32, then max(u, lo). f has 24 significant bits and span
//     is an f32, so the f64 product is exact and one f64 FMA rounds as
//     the plain path's multiply then add;
//   threefry_hash_launch: k0, k1, x0, x1, each a strided view over one
//     broadcast shape of up to kMaxDims axes (stride 0 where broadcast)
//     or a constant -> (N, 2), y0 and y1 of each element side by side,
//     so a two-word `fold_in` writes its new keys in one launch.
// Only the low 32 bits of each input are read.
//
// Output: int64 holding each uint32 word, the key-tree's convention
// (bits, hash); f32 (uniform).
//
// What bounds it on this card: 78 int32 operations a word by the
// definition (two adds before the rounds; 20 rounds of an add, a rotation
// and a xor; five injections of two key words and a constant; the xor of
// the two output words) against 8 bytes stored. The 41 rotations and
// xors run only on the integer ALU (64 a clock per SM); the adds also run on
// the FMA pipe (as IMAD), so the ALU bounds it, at about the time of
// the stores at 3.35 TB/s. What the design does about it:
//   1. each word is made once, in registers: uint32 arithmetic, each
//      rotation one funnel shift, the key schedule loaded and formed once
//      per key row;
//   2. bits: the counter is the word's index, formed in the kernel; x
//      of the grid runs over a row's words, y over the keys (grid-stride
//      loops both ways, rows of a few words share a block along y);
//   3. bits: each thread makes kWords words of its warp's span of
//      32 * kWords, one per lane stride, all hashed before any is stored
//      (independent chains for the pipe), so that each store instruction
//      writes 32 consecutive words (256 bytes) of the row;
//   4. hash: one element a thread, its offsets from the broadcast shape's
//      strides; its calls are a few million elements, so the index
//      arithmetic is left plain;
//   5. uniform: bits' grid (2), with the map applied in registers, so
//      each word is stored once, as 4 bytes of f32 where bits stores 8,
//      and is not read back: the torch map read and wrote each word
//      about ten times more. The map adds a shift and an or on the
//      integer ALU, and an f32 subtract, two conversions, an f64 FMA and
//      a max on other pipes, so the ALU still bounds it: 0.082 ms for a
//      (512, 65,536) draw at the definition's 41 ALU operations a word,
//      against 0.040 ms for its f32 stores. Each thread makes kWords
//      consecutive words and stores them as one float4 (a warp's store
//      512 consecutive bytes): on the card 0.1258 ms at (512, 65,536)
//      and 1.2093-1.2304 ms at (16,384, 20,000), against 0.1340-0.1355
//      and 1.2864-1.2890 ms with bits' layout (3) of one word a lane
//      stride apart (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;       // bits, uniform: a thread's words a pass
constexpr int kMaxDims = 4;     // hash: axes of the broadcast shape
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// The 20 rounds on counter (x0, x1) under the key schedule (k0, k1, k2).
__device__ __forceinline__ uint2 threefry20(uint32_t k0, uint32_t k1,
                                            uint32_t k2, uint32_t x0,
                                            uint32_t x1) {
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// Grid: x over a row's words, y over the keys; blockDim.x a multiple of
// 32, blockDim.y the rows a block holds.
__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(const long long* __restrict__ keys,
                     long long* __restrict__ out, long long n_keys,
                     long long n_words) {
  const long long span = static_cast<long long>(blockDim.x) * kWords;
  const long long first = static_cast<long long>(blockIdx.x) * span
                          + (threadIdx.x >> 5) * (32 * kWords)
                          + (threadIdx.x & 31);
  const long long step = static_cast<long long>(gridDim.x) * span;
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y
                     + threadIdx.y;
       r < n_keys; r += static_cast<long long>(gridDim.y) * blockDim.y) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
    const uint32_t k2 = k0 ^ k1 ^ kParity;
    long long* row = out + r * n_words;
    for (long long base = first; base < n_words; base += step) {
      uint32_t w[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const unsigned long long i =
            static_cast<unsigned long long>(base + 32 * j);
        const uint2 y = threefry20(k0, k1, k2, static_cast<uint32_t>(i >> 32),
                                   static_cast<uint32_t>(i));
        w[j] = y.x ^ y.y;
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        if (base + 32 * j < n_words) row[base + 32 * j] = w[j];
      }
    }
  }
}

// Grid as bits' (row_grid): thread t of x makes words kWords·t ...
// kWords·t + kWords − 1 of its row, so where a row holds a multiple of
// kWords words each thread stores them in one 16-byte float4 and a warp
// writes 512 consecutive bytes; a ragged row stores word by word.
__global__ void __launch_bounds__(kThreads)
threefry_uniform_kernel(const long long* __restrict__ keys,
                        float* __restrict__ out, long long n_keys,
                        long long n_words, float lo, float span) {
  static_assert(kWords == 4, "a thread's words are one float4");
  const double lo64 = lo;
  const double span64 = span;
  const bool whole = n_words % kWords == 0;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y
                     + threadIdx.y;
       r < n_keys; r += static_cast<long long>(gridDim.y) * blockDim.y) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
    const uint32_t k2 = k0 ^ k1 ^ kParity;
    float* row = out + r * n_words;
    for (long long q = first; q * kWords < n_words; q += step) {
      float u[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const unsigned long long i =
            static_cast<unsigned long long>(q * kWords + j);
        const uint2 y = threefry20(k0, k1, k2, static_cast<uint32_t>(i >> 32),
                                   static_cast<uint32_t>(i));
        const float f =
            __uint_as_float(((y.x ^ y.y) >> 9) | 0x3F800000u) - 1.0f;
        u[j] = fmaxf(__double2float_rn(
                         __fma_rn(static_cast<double>(f), span64, lo64)),
                     lo);
      }
      if (whole) {
        reinterpret_cast<float4*>(row)[q] =
            make_float4(u[0], u[1], u[2], u[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          if (q * kWords + j < n_words) row[q * kWords + j] = u[j];
        }
      }
    }
  }
}

// Operands k0, k1, x0, x1: a pointer with strides (in words) over the
// broadcast shape, or, where the pointer is null, a constant.
struct HashArgs {
  long long shape[kMaxDims];
  long long stride[4][kMaxDims];
  const long long* ptr[4];
  uint32_t value[4];
};

__global__ void __launch_bounds__(kThreads)
threefry_hash_kernel(const HashArgs a, long long n,
                     long long* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long off[4] = {0, 0, 0, 0};
    unsigned long long rest = static_cast<unsigned long long>(i);
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      const unsigned long long s = static_cast<unsigned long long>(a.shape[d]);
      if (s == 1) continue;
      const unsigned long long q = rest / s;
      const long long c = static_cast<long long>(rest - q * s);
      rest = q;
#pragma unroll
      for (int o = 0; o < 4; ++o) off[o] += c * a.stride[o][d];
    }
    uint32_t w[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      w[o] = a.ptr[o] ? static_cast<uint32_t>(a.ptr[o][off[o]]) : a.value[o];
    }
    const uint2 y = threefry20(w[0], w[1], w[0] ^ w[1] ^ kParity, w[2], w[3]);
    reinterpret_cast<longlong2*>(out)[i] =
        make_longlong2(static_cast<long long>(y.x),
                       static_cast<long long>(y.y));
  }
}

// The grid and block of the bits and uniform kernels for (n_keys,
// n_words), kWords words a thread: a short row takes a narrow block
// (whole warps) and shares the block with other rows along y; a long one
// takes kThreads along x.
struct RowGrid {
  dim3 grid, block;
};

RowGrid row_grid(long long n_keys, long long n_words) {
  const long long threads_row = (n_words + kWords - 1) / kWords;
  const int tx = static_cast<int>(
      threads_row >= kThreads ? kThreads : (threads_row + 31) / 32 * 32);
  const int ty = kThreads / tx;
  long long grid_x = (n_words + static_cast<long long>(tx) * kWords - 1)
                     / (static_cast<long long>(tx) * kWords);
  if (grid_x > 132 * 16) grid_x = 132 * 16;  // the loops do the rest
  long long grid_y = (n_keys + ty - 1) / ty;
  if (grid_y > 65535) grid_y = 65535;
  return {dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y)),
          dim3(tx, ty)};
}

}  // namespace

extern "C" {

// Writes (n_keys, n_words) int64 words into `out` on `stream`; returns
// cudaGetLastError() of the launch (0 on success). `keys` is (n_keys, 2)
// int64, contiguous.
int threefry_bits_launch(const void* keys, void* out, long long n_keys,
                         long long n_words, void* stream) {
  if (n_keys <= 0 || n_words <= 0) return 0;
  const RowGrid g = row_grid(n_keys, n_words);
  threefry_bits_kernel<<<g.grid, g.block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<long long*>(out),
      n_keys, n_words);
  return static_cast<int>(cudaGetLastError());
}

// Writes (n_keys, n_words) f32 uniforms into `out` on `stream`: word i of
// key k mapped to max(f32(f · span + lo), lo) (the note at the top);
// returns cudaGetLastError() of the launch. `keys` as for bits; `out`
// contiguous and 16-byte aligned (a fresh allocation is).
int threefry_uniform_launch(const void* keys, void* out, long long n_keys,
                            long long n_words, float lo, float span,
                            void* stream) {
  if (n_keys <= 0 || n_words <= 0) return 0;
  const RowGrid g = row_grid(n_keys, n_words);
  threefry_uniform_kernel<<<g.grid, g.block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<float*>(out), n_keys,
      n_words, lo, span);
  return static_cast<int>(cudaGetLastError());
}

// Writes (n, 2) int64 words into `out` on `stream`: y0, y1 of element e
// of the broadcast shape `shape` (kMaxDims axes, row-major, n elements).
// Operand o (k0, k1, x0, x1) is read at ptrs[o] + sum_d index_d *
// strides[o * kMaxDims + d], or is values[o] where ptrs[o] is null.
int threefry_hash_launch(long long n, const long long* shape,
                         const void* const* ptrs, const long long* values,
                         const long long* strides, void* out, void* stream) {
  if (n <= 0) return 0;
  HashArgs a;
  for (int d = 0; d < kMaxDims; ++d) a.shape[d] = shape[d];
  for (int o = 0; o < 4; ++o) {
    a.ptr[o] = static_cast<const long long*>(ptrs[o]);
    a.value[o] = static_cast<uint32_t>(values[o]);
    for (int d = 0; d < kMaxDims; ++d) {
      a.stride[o][d] = strides[o * kMaxDims + d];
    }
  }
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  threefry_hash_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, n, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
