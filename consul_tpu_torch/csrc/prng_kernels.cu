// Threefry-2x32 draws for Hopper (sm_90a), bound through ctypes.
//
// What it replaces. The JAX package draws every random number of its
// XLA engines through jax.random (split, fold_in, bits, uniform,
// randint, normal, exponential) and, in its lane engine, through
// jax.extend.random.threefry_2x32 directly (consul_tpu/sim/lanes.py:181,
// u01_global). No Pallas kernel computes them: XLA fuses each draw into
// one elementwise kernel. draw_kernel is that fusion for the port: one
// launch computes Threefry-2x32 (20 rounds, the key schedule of
// consul_tpu_torch/sim/prng.py) for every counter of one draw and
// writes the draw's output, where the plain PyTorch version
// (prng._threefry_i32) runs ~140 elementwise launches a draw.
//
// Modes (template MODE), each the fused tail of one plain function:
//   WORDS  both output words as int64 pairs [..., 2] (threefry2x32,
//          fold_in, split, round_keys);
//   XOR    y0 ^ y1 as int64 (bits);
//   SEEDS  (y0 ^ y1) >> 1 as int32 (round_seeds);
//   UNIFORM (y0 ^ y1) >> 9 as the f32 mantissa of [0, 1), scaled as
//          prng.uniform scales it: nothing for [0, 1); a power-of-two
//          width in f32 (one product, exact, one rounded sum); any other
//          width as the f64 product and sum rounded once to f32; then
//          max(lo, .);
//   U01    (y0 >> 8) * 2^-24 (the lane engine's u01_global).
//
// Counters. Word 1 is a data tensor's word (fold_in), a generated index
// j along the draw's last dimension plus an optional device base
// (split, bits, uniform: j; round_keys, u01_global: start + j), or
// both zero; word 0 is a data word, (base + j) >> 32 (bits), or zero.
// Every operand is read through element strides over the draw's index
// space (a broadcast key stack has stride 0 along the draws it shares),
// so no counter or key is materialised. The base is read from device
// memory: a captured graph replays a moved offset or round index.
//
// What bounds it. Operations: a word costs ~72 integer operations (20
// rotations of add, funnel shift and xor; 5 key injections) against 4-16
// bytes written, so at 3.35 TB/s and ~16.7 T int32 ops/s the card does
// ~4.5 ops a byte before memory is the limit and this kernel does 4.5-18.
// The design: a rotation is one __funnelshift_l, the key schedule is
// held in registers per row, the counter is computed, and a grid-stride
// loop over the last dimension gives each thread several words with
// coalesced stores (the simple first version; a later one may unroll
// words per thread).
//
// Build with -fmad=false (utils/build.py): the f64 product and sum of
// the uniform's general width stay two roundings, as in the plain
// version; they are written with __dmul_rn / __dadd_rn besides.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIMS = 6;
constexpr int THREADS = 256;
// at most this many blocks a launch (8 of 256 threads on each SM)
constexpr int MAX_BLOCKS = 132 * 8;
constexpr uint32_t KS_PARITY = 0x1BD11BDA;

enum Mode { WORDS = 0, XOR = 1, SEEDS = 2, UNIFORM = 3, U01 = 4 };
enum Scale { SCALE_UNIT = 0, SCALE_POW2 = 1, SCALE_F64 = 2 };

}  // namespace

// Mirror of fused.DrawArgs: operand pointers (int64 words; x0, x1 and
// base may be null), the output, the index space and each operand's
// element strides over it.
struct DrawArgs {
  const int64_t* k0;
  const int64_t* k1;
  const int64_t* x0;
  const int64_t* x1;
  const int64_t* base;
  void* out;
  int ndim;
  int gen;
  int gen_hi;
  int scale;
  float lo;
  float width;
  int64_t size[MAX_DIMS];
  int64_t sk0[MAX_DIMS];
  int64_t sk1[MAX_DIMS];
  int64_t sx0[MAX_DIMS];
  int64_t sx1[MAX_DIMS];
};

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on (x0, x1) under key (k0, k1): the
// rotations (13, 15, 26, 6) / (17, 29, 16, 24) and the key schedule
// (k0, k1, k0 ^ k1 ^ KS_PARITY) of prng._threefry_i32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_EVEN
#undef TF_ODD
#undef TF_ROUND
}

__device__ __forceinline__ float scale_uniform(float f, const DrawArgs& a) {
  if (a.scale == SCALE_UNIT) return f;
  float v;
  if (a.scale == SCALE_POW2) {
    v = __fadd_rn(__fmul_rn(f, a.width), a.lo);
  } else {
    v = __double2float_rn(__dadd_rn(__dmul_rn((double)f, (double)a.width),
                                    (double)a.lo));
  }
  return fmaxf(v, a.lo);
}

// Rows are the index space's leading dimensions (blockIdx.y strides
// them), words its last one (blockIdx.x and the threads stride them).
template <int MODE>
__global__ void __launch_bounds__(THREADS) draw_kernel(DrawArgs a) {
  const int last = a.ndim - 1;
  const int64_t words = a.size[last];
  int64_t rows = 1;
  for (int d = 0; d < last; ++d) rows *= a.size[d];
  const int64_t base = a.base != nullptr ? *a.base : 0;
  const int64_t sk0 = a.sk0[last], sk1 = a.sk1[last];
  const int64_t sx0 = a.sx0[last], sx1 = a.sx1[last];
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    int64_t rem = row, ok0 = 0, ok1 = 0, ox0 = 0, ox1 = 0;
    for (int d = last - 1; d >= 0; --d) {
      const int64_t i = rem % a.size[d];
      rem /= a.size[d];
      ok0 += i * a.sk0[d];
      ok1 += i * a.sk1[d];
      ox0 += i * a.sx0[d];
      ox1 += i * a.sx1[d];
    }
    for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < words;
         j += step) {
      const uint32_t k0 = (uint32_t)a.k0[ok0 + j * sk0];
      const uint32_t k1 = (uint32_t)a.k1[ok1 + j * sk1];
      uint32_t x0 = a.x0 != nullptr ? (uint32_t)a.x0[ox0 + j * sx0] : 0u;
      uint32_t x1 = a.x1 != nullptr ? (uint32_t)a.x1[ox1 + j * sx1] : 0u;
      if (a.gen) {
        const int64_t g = base + j;
        x1 += (uint32_t)g;
        if (a.gen_hi) x0 += (uint32_t)((uint64_t)g >> 32);
      }
      threefry(k0, k1, x0, x1);
      const int64_t o = row * words + j;
      if (MODE == WORDS) {
        int64_t* out = (int64_t*)a.out;
        out[2 * o] = (int64_t)x0;
        out[2 * o + 1] = (int64_t)x1;
      } else if (MODE == XOR) {
        ((int64_t*)a.out)[o] = (int64_t)(x0 ^ x1);
      } else if (MODE == SEEDS) {
        ((int32_t*)a.out)[o] = (int32_t)((x0 ^ x1) >> 1);
      } else if (MODE == UNIFORM) {
        const float f = __fmul_rn(__uint2float_rn((x0 ^ x1) >> 9),
                                  0x1p-23f);
        ((float*)a.out)[o] = scale_uniform(f, a);
      } else {
        ((float*)a.out)[o] = __fmul_rn(__uint2float_rn(x0 >> 8), 0x1p-24f);
      }
    }
  }
}

template <int MODE>
void launch(const DrawArgs& a, dim3 grid, cudaStream_t stream) {
  draw_kernel<MODE><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" {

int prng_kernels_max_dims() { return MAX_DIMS; }

// One draw: the index space's rows over blockIdx.y (at most 65,535, each
// block then strides), its words over blockIdx.x, at most MAX_BLOCKS
// blocks in all. Returns cudaGetLastError() after the launch (0 = ok).
int launch_threefry(DrawArgs a, int mode, void* stream) {
  if (a.ndim < 1 || a.ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  const int64_t words = a.size[a.ndim - 1];
  int64_t rows = 1;
  for (int d = 0; d < a.ndim - 1; ++d) rows *= a.size[d];
  if (words == 0 || rows == 0) return 0;
  int64_t bx = (words + THREADS - 1) / THREADS;
  if (bx > MAX_BLOCKS) bx = MAX_BLOCKS;
  int64_t by = MAX_BLOCKS / bx;
  if (by < 1) by = 1;
  if (by > rows) by = rows;
  if (by > 65535) by = 65535;
  const dim3 grid((unsigned)bx, (unsigned)by);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case WORDS: launch<WORDS>(a, grid, s); break;
    case XOR: launch<XOR>(a, grid, s); break;
    case SEEDS: launch<SEEDS>(a, grid, s); break;
    case UNIFORM: launch<UNIFORM>(a, grid, s); break;
    case U01: launch<U01>(a, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* prng_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
