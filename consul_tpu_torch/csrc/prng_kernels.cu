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
// Derived keys. A draw may fold one word into its key first, as
// fold_in(k, d) = threefry(k, (0, d)) does, in registers:
//   DERIVE_ROW  d is a word of the argument table, dword[row % nderive]
//               (split(k, S)[s] and fold_in(k, REPLAY_FOLD) are such
//               keys: a round's slots are the rows of one launch);
//   DERIVE_GEN  d is the generated index base + j, which then leaves the
//               counter at its data words (round_seeds: the seed of
//               round r is bits(fold_in(k, r)) >> 1, two evaluations).
//
// What bounds it. Operations: a word costs ~72 integer operations (20
// rotations of add, funnel shift and xor; 5 key injections) against 4-16
// bytes written, so at 3.35 TB/s and ~16.7 T int32 ops/s the card does
// ~4.5 ops a byte before memory is the limit and this kernel does 4.5-18.
// The small draws (round keys, seeds, a round's slots) are bound by the
// launch itself, so a round's key derivation and its slots' draws are one
// launch.
//
// The design. A large launch gives each thread VEC consecutive words of a
// row, unrolled, written with one vector store where the row starts on a
// vector boundary (a scalar tail otherwise); a small one (SMALL_WORDS) a
// word a thread, since its time is one word's latency spread over more
// warps and SMs (on an H100, 48 to 16,384 words: 0.2-0.9 us faster a
// launch than 4 words a thread; kernel_ab.py --draws). Where the key and
// the counter's data are the same along a row (stride 0: every main-path
// draw), the block makes each row's key once into shared memory, derived
// there where the draw says, and a word costs its counter's multiply-add
// and its threefry alone: no load, no branch. Indices are 32-bit when the
// launch's index space is under 2^31 words (INDEX32_LIMIT), 64-bit
// otherwise; of the counter base a draw reads the low word (a counter
// word wraps at 2^32, and gen_hi takes no base). The grid is sized by the
// kernel's occupancy on the card's SMs and strides what it does not cover.
//
// Build with -fmad=false (utils/build.py): the f64 product and sum of
// the uniform's general width stay two roundings, as in the plain
// version; they are written with __dmul_rn / __dadd_rn besides.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIMS = 6;
constexpr int MAX_DERIVE = 8;
constexpr int THREADS = 256;
// consecutive words a thread of a large launch; a launch of at most
// SMALL_WORDS takes one
constexpr int VEC = 4;
constexpr int64_t SMALL_WORDS = int64_t(1) << 16;
// the 32-bit path's index spaces: under 2^31 words, less room for the
// grid's stride past the last word
constexpr int64_t INDEX32_LIMIT = (int64_t(1) << 31) - (int64_t(1) << 24);
constexpr uint32_t KS_PARITY = 0x1BD11BDA;

enum Mode { WORDS = 0, XOR = 1, SEEDS = 2, UNIFORM = 3, U01 = 4 };
enum Scale { SCALE_UNIT = 0, SCALE_POW2 = 1, SCALE_F64 = 2 };
enum Derive { DERIVE_NONE = 0, DERIVE_ROW = 1, DERIVE_GEN = 2 };

}  // namespace

// Mirror of fused.DrawArgs: operand pointers (int64 words; x0, x1 and
// base may be null), the output, the index space and each operand's
// element strides over it, and the key derivation with its word table;
// rows is the product of the leading sizes (launch_threefry sets it).
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
  int derive;
  int nderive;
  uint32_t dword[MAX_DERIVE];
  int64_t rows;
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

// fold_in: the key (k0, k1) becomes threefry((k0, k1), (0, d))
__device__ __forceinline__ void derive_key(uint32_t& k0, uint32_t& k1,
                                           uint32_t d) {
  uint32_t y0 = 0u, y1 = d;
  threefry(k0, k1, y0, y1);
  k0 = y0;
  k1 = y1;
}

// the low word of an int64 operand word (the words hold [0, 2^32))
__device__ __forceinline__ uint32_t lo32(const int64_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
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

// Element offsets of a row's first word in the four operands: the row's
// index over the leading dimensions (the outermost takes the remainder,
// so a draw of at most two dimensions divides nothing).
__device__ __forceinline__ void row_offsets(const DrawArgs& a, int64_t row,
                                            int64_t o[4]) {
  o[0] = o[1] = o[2] = o[3] = 0;
  int64_t rem = row;
#pragma unroll 1
  for (int d = a.ndim - 2; d >= 0; --d) {
    int64_t i = rem;
    if (d > 0) {
      i = rem % a.size[d];
      rem /= a.size[d];
    }
    o[0] += i * a.sk0[d];
    o[1] += i * a.sk1[d];
    o[2] += i * a.sx0[d];
    o[3] += i * a.sx1[d];
  }
}

__device__ __forceinline__ uint32_t table_word(const DrawArgs& a,
                                               int64_t row) {
  return a.dword[(uint32_t)(row % a.nderive)];
}

// The `valid` (1 .. V) words of one thread, from output word o on: one
// vector store where `vec` (V = 4, all valid, o on a vector boundary, the
// output on 16 bytes), else scalar stores; a word's pair in the WORDS mode
// is a vector of its own wherever the output is `aligned`.
template <int MODE, int V>
__device__ __forceinline__ void store(const DrawArgs& a, int64_t o,
                                      const uint32_t (&y0)[V],
                                      const uint32_t (&y1)[V], int valid,
                                      bool vec, bool aligned) {
  if (MODE == WORDS) {
    long long* out = reinterpret_cast<long long*>(a.out) + 2 * o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v >= valid) continue;
      if (aligned) {
        reinterpret_cast<longlong2*>(out)[v] = make_longlong2(y0[v], y1[v]);
      } else {
        out[2 * v] = y0[v];
        out[2 * v + 1] = y1[v];
      }
    }
  } else if (MODE == XOR) {
    long long w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = (long long)(y0[v] ^ y1[v]);
    long long* out = reinterpret_cast<long long*>(a.out) + o;
    if (V == 4 && vec) {
      reinterpret_cast<longlong2*>(out)[0] = make_longlong2(w[0], w[1]);
      reinterpret_cast<longlong2*>(out)[1] = make_longlong2(w[2], w[3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < valid) out[v] = w[v];
    }
  } else if (MODE == SEEDS) {
    int w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = (int)((y0[v] ^ y1[v]) >> 1);
    int* out = reinterpret_cast<int*>(a.out) + o;
    if (V == 4 && vec) {
      *reinterpret_cast<int4*>(out) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < valid) out[v] = w[v];
    }
  } else {
    float w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (MODE == UNIFORM) {
        w[v] = scale_uniform(
            __fmul_rn(__uint2float_rn((y0[v] ^ y1[v]) >> 9), 0x1p-23f), a);
      } else {
        w[v] = __fmul_rn(__uint2float_rn(y0[v] >> 8), 0x1p-24f);
      }
    }
    float* out = reinterpret_cast<float*>(a.out) + o;
    if (V == 4 && vec) {
      *reinterpret_cast<float4*>(out) = make_float4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < valid) out[v] = w[v];
    }
  }
}

// Rows are the index space's leading dimensions (blockIdx.y strides
// them), words its last one (blockIdx.x and the threads stride them, V
// words a thread). I is the index type. ROW: the key and the counter's
// data are the same along a row (stride 0), so a word costs its
// counter's add and its threefry alone: each thread reads its row's key,
// or, where the draw derives it (DERIVE_ROW), the block derives each
// row's key once into shared memory. Otherwise every word reads its own
// operands.
template <int MODE, typename I, bool ROW, int V>
__global__ void __launch_bounds__(THREADS) draw_kernel(DrawArgs a) {
  __shared__ uint32_t row_key[2][ROW ? THREADS : 1];
  const int last = a.ndim - 1;
  const I words = (I)a.size[last];
  const int64_t rows = a.rows;
  const I step = (I)gridDim.x * (THREADS * V);
  const I first_j = (I)blockIdx.x * (THREADS * V) + (I)threadIdx.x * V;
  const int64_t rstep = gridDim.y;
  // the generated index enters the counter (not the key) as j * gen_mul
  const bool gen_ctr = a.gen && a.derive != DERIVE_GEN;
  const uint32_t gen_mul = gen_ctr ? 1u : 0u;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.out) % 16) == 0;
  const bool shared_keys = ROW && a.derive == DERIVE_ROW;
  // this block's rows, blockIdx.y + m * rstep, in batches of THREADS
  for (int64_t batch = blockIdx.y; batch < rows; batch += rstep * THREADS) {
    if (shared_keys) {
      __syncthreads();  // the last batch's keys are read
      const int64_t row = batch + threadIdx.x * rstep;
      if (row < rows) {
        int64_t off[4];
        row_offsets(a, row, off);
        uint32_t k0 = lo32(a.k0 + off[0]), k1 = lo32(a.k1 + off[1]);
        derive_key(k0, k1, table_word(a, row));
        row_key[0][threadIdx.x] = k0;
        row_key[1][threadIdx.x] = k1;
      }
      __syncthreads();
    }
    for (int b = 0; b < THREADS; ++b) {
      const int64_t row = batch + b * rstep;
      if (row >= rows) break;
      const int64_t orow = row * (int64_t)words;
      const bool vec = V == 4 && aligned && orow % V == 0;
      int64_t off[4] = {0, 0, 0, 0};
      if (!shared_keys || a.x0 != nullptr || a.x1 != nullptr)
        row_offsets(a, row, off);
      const int64_t* px0 = a.x0 != nullptr ? a.x0 + off[2] : nullptr;
      const int64_t* px1 = a.x1 != nullptr ? a.x1 + off[3] : nullptr;
      // the base's low word (its only one that a draw reads), loaded
      // beside the row's key and data: one memory latency, not two
      const uint32_t base = a.base != nullptr ? lo32(a.base) : 0u;
      const uint32_t base_lo = gen_ctr ? base : 0u;
      if (ROW) {
        const uint32_t k0 = shared_keys ? row_key[0][b] : lo32(a.k0 + off[0]);
        const uint32_t k1 = shared_keys ? row_key[1][b] : lo32(a.k1 + off[1]);
        const uint32_t c0 = px0 != nullptr ? lo32(px0) : 0u;
        const uint32_t c1 = (px1 != nullptr ? lo32(px1) : 0u) + base_lo;
        for (I j0 = first_j; j0 < words; j0 += step) {
          uint32_t y0[V], y1[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const I j = j0 + v;
            uint32_t x0 = c0, x1 = c1 + (uint32_t)j * gen_mul;
            // (j >> 32: fused.draw takes gen_hi without a base)
            if (sizeof(I) == 8 && a.gen_hi)
              x0 += (uint32_t)((uint64_t)j >> 32);
            threefry(k0, k1, x0, x1);
            y0[v] = x0;
            y1[v] = x1;
          }
          const I left = words - j0;
          store<MODE, V>(a, orow + j0, y0, y1, left < V ? (int)left : V,
                         vec && left >= V, aligned);
        }
        continue;
      }
      const I sk0 = (I)a.sk0[last], sk1 = (I)a.sk1[last];
      const I sx0 = (I)a.sx0[last], sx1 = (I)a.sx1[last];
      const int64_t* pk0 = a.k0 + off[0];
      const int64_t* pk1 = a.k1 + off[1];
      const uint32_t rowd = a.derive == DERIVE_ROW ? table_word(a, row) : 0u;
      for (I j0 = first_j; j0 < words; j0 += step) {
        uint32_t y0[V], y1[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const I j = j0 + v;
          // a tail's words past the row read the row's last operands
          const I jr = j < words ? j : words - 1;
          uint32_t k0 = lo32(pk0 + jr * sk0), k1 = lo32(pk1 + jr * sk1);
          if (a.derive == DERIVE_ROW)
            derive_key(k0, k1, rowd);
          else if (a.derive == DERIVE_GEN)
            derive_key(k0, k1, base + (uint32_t)j);
          uint32_t x0 = px0 != nullptr ? lo32(px0 + jr * sx0) : 0u;
          uint32_t x1 = (px1 != nullptr ? lo32(px1 + jr * sx1) : 0u)
              + base_lo + (uint32_t)j * gen_mul;
          if (a.gen_hi) x0 += (uint32_t)((uint64_t)j >> 32);
          threefry(k0, k1, x0, x1);
          y0[v] = x0;
          y1[v] = x1;
        }
        const I left = words - j0;
        store<MODE, V>(a, orow + j0, y0, y1, left < V ? (int)left : V,
                       vec && left >= V, aligned);
      }
    }
  }
}

// The blocks of one launch: as many as the card holds at once (the
// kernel's occupancy on every SM, measured once an instantiation).
template <int MODE, typename I, bool ROW, int V>
int resident_blocks(int* out) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, draw_kernel<MODE, I, ROW, V>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached;
  return 0;
}

template <int MODE, typename I, bool ROW, int V>
int launch(const DrawArgs& a, int64_t rows, int64_t words,
           cudaStream_t stream) {
  int cap = 0;
  const int rc = resident_blocks<MODE, I, ROW, V>(&cap);
  if (rc != 0) return rc;
  int64_t bx = (words + THREADS * V - 1) / (THREADS * V);
  if (bx > cap) bx = cap;
  int64_t by = cap / bx;
  if (by < 1) by = 1;
  if (by > rows) by = rows;
  if (by > 65535) by = 65535;
  draw_kernel<MODE, I, ROW, V>
      <<<dim3((unsigned)bx, (unsigned)by), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// A small launch takes a word a thread (its time is the launch and one
// word's latency, which more warps on more SMs share), a large one VEC
// words a thread (its time is the card's issue rate); 32-bit indices but
// past INDEX32_LIMIT.
template <int MODE>
int launch_mode(const DrawArgs& a, int64_t rows, int64_t words, bool idx32,
                bool row, cudaStream_t s) {
  if (rows * words <= SMALL_WORDS)
    return row ? launch<MODE, int32_t, true, 1>(a, rows, words, s)
               : launch<MODE, int32_t, false, 1>(a, rows, words, s);
  if (idx32)
    return row ? launch<MODE, int32_t, true, VEC>(a, rows, words, s)
               : launch<MODE, int32_t, false, VEC>(a, rows, words, s);
  return row ? launch<MODE, int64_t, true, VEC>(a, rows, words, s)
             : launch<MODE, int64_t, false, VEC>(a, rows, words, s);
}

int64_t abs64(int64_t v) { return v < 0 ? -v : v; }

}  // namespace

extern "C" {

int prng_kernels_max_dims() { return MAX_DIMS; }

int prng_kernels_max_derive() { return MAX_DERIVE; }

// One draw: the index space's rows over blockIdx.y (at most 65,535, each
// block then strides), its words over blockIdx.x, one or VEC a thread.
// gen_hi takes no base (bits: the index's high word is j >> 32). Returns
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// for arguments the kernel does not take.
int launch_threefry(DrawArgs a, int mode, void* stream) {
  if (a.ndim < 1 || a.ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  if (a.derive == DERIVE_ROW &&
      (a.nderive < 1 || a.nderive > MAX_DERIVE))
    return (int)cudaErrorInvalidValue;
  if ((a.derive == DERIVE_GEN && (!a.gen || a.gen_hi)) ||
      (a.gen_hi && (!a.gen || a.base != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int last = a.ndim - 1;
  const int64_t words = a.size[last];
  int64_t rows = 1;
  for (int d = 0; d < last; ++d) rows *= a.size[d];
  if (words == 0 || rows == 0) return 0;
  a.rows = rows;
  // 32-bit indices: the index space and every operand's span along a
  // row stay under the limit
  bool idx32 = rows <= INDEX32_LIMIT / words;
  for (const int64_t* s : {a.sk0, a.sk1, a.sx0, a.sx1})
    idx32 = idx32 && abs64(s[last]) <= INDEX32_LIMIT / words;
  const bool row = a.sk0[last] == 0 && a.sk1[last] == 0 &&
                   a.sx0[last] == 0 && a.sx1[last] == 0 &&
                   a.derive != DERIVE_GEN;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case WORDS: return launch_mode<WORDS>(a, rows, words, idx32, row, s);
    case XOR: return launch_mode<XOR>(a, rows, words, idx32, row, s);
    case SEEDS: return launch_mode<SEEDS>(a, rows, words, idx32, row, s);
    case UNIFORM:
      return launch_mode<UNIFORM>(a, rows, words, idx32, row, s);
    case U01: return launch_mode<U01>(a, rows, words, idx32, row, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* prng_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
