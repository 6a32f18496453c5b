// Fixed-order f32 row sums for Hopper (sm_90a), bound through ctypes.
//
// What it replaces. The JAX package sums its population lanes with
// jnp.sum / .sum(axis=...) (consul_tpu/sim/lanes.py:199, :264, :303;
// round.py:114), which XLA compiles into one reduce. The port sums in
// one fixed order, lanes.tree_sum (consul_tpu_torch/sim/lanes.py), so a
// grid row is bit for bit its one-point run: at each step of length n,
// element i adds element i + n/2 (rounded down), and an odd n carries
// its last element to the next step. The plain version runs that as one
// or two launches a step (~16-20 a sum); these kernels compute the same
// tree of additions in one or two launches.
//
// The order. Call level k the array after k steps (n_0 = L, n_{k+1} =
// ceil(n_k / 2), h_k = floor(n_k / 2)). Position p of level k is
// level(k-1, p) + level(k-1, p + h_{k-1}) when p < h_{k-1}, and
// level(k-1, 2 h_{k-1}) (the carried element, no addition) when p ==
// h_{k-1}. Unrolled K levels down, position p of level K is a binary
// tree over the leaves p + sum of h_b over the set bits b of m, m in
// [0, 2^K), combined pairwise in the order of m (a binary counter). Only
// the last position of a level ever carries, so every position but the
// last has that full tree; in the last one's, leaf m (not all ones) is
// absent when n_j is odd for j its highest zero bit (the carry took the
// left branch away), and a node with an absent side passes the other
// side on unchanged. So:
//   level_kernel  one thread a (row, position) of level K: the leaves'
//                 tree, written to a [rows, n_K] scratch;
//   rows_kernel   one block a row: level K into shared memory (K may be
//                 0: a plain load), then the remaining steps there,
//                 one __syncthreads a step.
// A row sum is rows_kernel alone when the row fits shared memory or the
// rows fill the card, else level_kernel then rows_kernel
// (fused.sum_plan picks; lanes.tree_sum_staged is the plain twin of the
// plan). Each addition is the plain version's, in its order: the bits,
// the sign of a zero and the NaNs included.
//
// What bounds it. Bytes: one f32 read and one add an element (at 3.35
// TB/s and 67 T f32 ops/s, ~20x below the operation bound). The design:
// threads of a warp walk neighbouring positions, so each leaf load is
// one coalesced 128-byte line; a full tree's leaves are loaded 8 at a
// time (full_value), so a thread keeps 8 loads in flight; the tree's
// partial sums sit in a small per-thread stack (at most K deep,
// K <= 23).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 24;
// the longest level the block stage holds in shared memory
constexpr int SMEM_N = 1024;

}  // namespace

// Mirror of fused.SumStage: the rows and their length, the levels K a
// thread unrolls, the level length n_K, n_j's parity as bit j, and the
// leaf offset's step after leaf m: delta[t] = h_t - sum_{b<t} h_b for t
// the trailing ones of m.
struct SumStage {
  int64_t rows;
  int64_t length;
  int64_t nk;
  int64_t odd;
  int k;
  int plus_zero;
  int64_t delta[MAX_LEVELS];
};

namespace {

// Position p of level K of a full tree (every position but the last),
// K >= 3: the leaves come in groups of 8 (the low three bits of m), each
// group's 8 loads issued together and added as the tree adds them, then
// the groups combined in the order of m >> 3 like the leaves below.
__device__ float full_value(const float* __restrict__ x, int64_t p,
                            const SumStage& s) {
  const int k = s.k;
  const int64_t h0 = s.delta[0];
  const int64_t h1 = s.delta[1] + h0;
  const int64_t h2 = s.delta[2] + h1 + h0;
  const uint32_t full = (1u << (k - 3)) - 1u;
  float stack[MAX_LEVELS];
  int sp = 0;
  int64_t off = p;
  for (uint32_t g = 0;; ++g) {
    const float* q = x + off;
    const float v0 = q[0], v1 = q[h0], v2 = q[h1], v3 = q[h1 + h0];
    const float v4 = q[h2], v5 = q[h2 + h0], v6 = q[h2 + h1];
    const float v7 = q[h2 + h1 + h0];
    float v = __fadd_rn(__fadd_rn(__fadd_rn(v0, v1), __fadd_rn(v2, v3)),
                        __fadd_rn(__fadd_rn(v4, v5), __fadd_rn(v6, v7)));
    const int t = __ffs(~g) - 1;  // trailing ones of g
    for (int i = 0; i < t; ++i) v = __fadd_rn(stack[--sp], v);
    if (g == full) return v;
    stack[sp++] = v;
    // from leaf 8g to leaf 8(g + 1): h_{t+3} - sum of h_b for 3 <= b <
    // t + 3, which is (h0 + h1 + h2) + delta[t + 3]
    off += h2 + h1 + h0 + s.delta[t + 3];
  }
}

// Position p of level K of the row at x (see the note above).
__device__ float level_value(const float* __restrict__ x, int64_t p,
                             const SumStage& s) {
  const int k = s.k;
  if (k == 0) return x[p];
  const bool last = p == s.nk - 1;
  if (k >= 3 && !last) return full_value(x, p, s);
  const uint32_t full = (1u << k) - 1u;
  float stack[MAX_LEVELS];
  uint32_t present = 0;  // bit i: stack[i] holds a value
  int sp = 0;
  int64_t off = 0;
  for (uint32_t m = 0;; ++m) {
    bool vp = true;
    if (last && m != full) {
      const int hz = 31 - __clz(~m & full);
      vp = ((s.odd >> hz) & 1) == 0;
    }
    float v = vp ? x[p + off] : 0.0f;
    const int t = __ffs(~m) - 1;  // trailing ones of m
    for (int i = 0; i < t; ++i) {
      --sp;
      if ((present >> sp) & 1u) {
        v = vp ? __fadd_rn(stack[sp], v) : stack[sp];
        vp = true;
      }
    }
    if (m == full) return v;
    stack[sp] = v;
    present = vp ? present | (1u << sp) : present & ~(1u << sp);
    ++sp;
    off += s.delta[t];
  }
}

__global__ void __launch_bounds__(THREADS)
    level_kernel(const float* __restrict__ x, SumStage s,
                 float* __restrict__ y) {
  const int64_t total = s.rows * s.nk;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t r = i / s.nk;
    y[i] = level_value(x + r * s.length, i - r * s.nk, s);
  }
}

__global__ void __launch_bounds__(THREADS)
    rows_kernel(const float* __restrict__ x, SumStage s,
                float* __restrict__ out) {
  __shared__ float buf[SMEM_N];
  for (int64_t r = blockIdx.x; r < s.rows; r += gridDim.x) {
    const float* row = x + r * s.length;
    for (int64_t p = threadIdx.x; p < s.nk; p += THREADS)
      buf[p] = level_value(row, p, s);
    __syncthreads();
    int64_t n = s.nk;
    while (n > 1) {
      const int64_t h = n >> 1;
      // position 0's thread reads buf[h] before the carry overwrites it,
      // and is the only reader of buf[h] this step
      for (int64_t i = threadIdx.x; i < h; i += THREADS) {
        buf[i] = __fadd_rn(buf[i], buf[i + h]);
        if (i == 0 && (n & 1)) buf[h] = buf[n - 1];
      }
      __syncthreads();
      n = h + (n & 1);
    }
    if (threadIdx.x == 0)
      out[r] = s.plus_zero ? __fadd_rn(buf[0], 0.0f) : buf[0];
    __syncthreads();
  }
}

unsigned blocks_for(int64_t units) {
  const int64_t most = 65535;
  return (unsigned)(units < 1 ? 1 : (units > most ? most : units));
}

}  // namespace

extern "C" {

void sum_kernels_layout(int* max_levels, int* smem_n) {
  *max_levels = MAX_LEVELS;
  *smem_n = SMEM_N;
}

// level K of every row into y ([rows, nk]); 0 = ok, else the CUDA error
int launch_sum_level(const void* x, SumStage s, void* y, void* stream) {
  if (s.k < 1 || s.k > MAX_LEVELS - 1) return (int)cudaErrorInvalidValue;
  level_kernel<<<blocks_for((s.rows * s.nk + THREADS - 1) / THREADS),
                 THREADS, 0, (cudaStream_t)stream>>>((const float*)x, s,
                                                     (float*)y);
  return (int)cudaGetLastError();
}

// every row's sum into out ([rows]); 0 = ok, else the CUDA error
int launch_sum_rows(const void* x, SumStage s, void* out, void* stream) {
  if (s.k < 0 || s.k > MAX_LEVELS - 1 || s.nk > SMEM_N)
    return (int)cudaErrorInvalidValue;
  rows_kernel<<<blocks_for(s.rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, s, (float*)out);
  return (int)cudaGetLastError();
}

const char* sum_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
