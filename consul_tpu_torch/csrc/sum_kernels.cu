// Fixed-order f32 row sums for Hopper (sm_90a), bound through ctypes.
//
// What it replaces. The JAX package sums its population lanes with
// jnp.sum / .sum(axis=...) (consul_tpu/sim/lanes.py:199, :264, :303;
// round.py:114), which XLA compiles into one reduce. The port sums in
// one fixed order, lanes.tree_sum (consul_tpu_torch/sim/lanes.py), so a
// grid row is bit for bit its one-point run: at each step of length n,
// element i adds element i + n/2 (rounded down), and an odd n carries
// its last element to the next step. The plain version runs that as one
// or two launches a step (~16-20 a sum); sum_kernel computes the same
// tree of additions in one launch a sum, at every shape.
//
// The order. Call level k the array after k steps (n_0 = L, n_{k+1} =
// ceil(n_k / 2), h_k = floor(n_k / 2), so n_k = n_{k+1} + h_k). Position
// p of level k is level(k-1, p) + level(k-1, p + h_{k-1}) when p <
// h_{k-1}, and level(k-1, 2 h_{k-1}) (the carried element, no addition)
// when p == h_{k-1}. Unrolled K levels down, position p of level K is a
// binary tree over the leaves p + sum of h_b over the set bits b of m, m
// in [0, 2^K), combined pairwise in the order of m (a binary counter).
// Only the last position of a level ever carries, so every position but
// the last has that full tree, and so do all of its level-(K-j)
// constituents p + sum of h_b over the set bits b >= K-j of m (they are
// at most n_{K-j} - 2). The last position's tree is the same tree in
// which the node on the last chain (the rightmost node of its height)
// that joins the step from level b passes its right side on alone when
// n_b is odd: its left side holds leaves that the carry took away.
// Every leaf of the last position lies inside the row, so the absent
// ones are loaded and dropped, never added.
//
// The launch. sum_plan (consul_tpu_torch/sim/fused.py) cuts level K of
// every row into ranges of `width` positions, one CTA a range
// (`chunks` a row: one float4 group a thread when the rows do not fill
// the card, four when they do, so that many rows keep one CTA a row),
// and picks T <= 4:
//   1. each thread computes level-T positions: the tree of 2^T leaves
//      in registers (Tree, unrolled at compile time: no stack), for 4
//      adjacent positions at once with one float4 load a leaf where the
//      row length and every h_b are multiples of 4 (then T = 4) and the
//      base is 16-byte aligned (the leaf offsets do not depend on the
//      position, so the 4 values are contiguous), else for one with
//      scalar loads.
//      A CTA's range [a, a + w) of level K needs the 2^j segments (j =
//      K - T) a + [0, w) + sum of h_b over the set bits b of g of level
//      T; segment g goes to shared-memory slot bitreverse_j(g).
//   2. the CTA joins levels T .. K in shared memory: in that layout the
//      step from level T + b is a halving of the slots (element i adds
//      element i + half), with the last chain's rule at the last element
//      of the first half when the CTA owns level K's last position.
//   3. one CTA a row (n_K = n_T; short rows pack several to a CTA, so
//      that every thread has a float4 group): it folds them to the sum.
//      Several CTAs a row: each
//      writes its range to a [rows, n_K] scratch, runs __threadfence()
//      and takes a ticket from the row's arrival counter (atomicAdd);
//      the CTA that draws the last one re-zeroes the counter, reads the
//      row's n_K positions through L2 (__ldcg) and folds them.
//   The fold halves in shared memory, one __syncthreads a step, down to
//   32 positions, and runs the last five steps in one warp by
//   __shfl_down_sync (lane i adds lane i + h; an odd n moves lane n - 1
//   to lane h). lanes.tree_sum_staged computes the same partials in
//   PyTorch (level T, the CTAs' ranges, the fold). Each addition is the
//   plain version's, in its order: the bits, the sign of a zero and the
//   NaNs included.
//
// What bounds it. Bytes: one f32 read and one add an element (at 3.35
// TB/s and 67 T f32 ops/s, ~20x below the operation bound). A thread
// keeps 2^T = 16 leaf loads (256 bytes as float4) in flight, a warp's
// loads of one leaf are contiguous lines, offsets within a row are
// 32-bit, and a few long rows spread over the card. A cut row's CTAs own
// at least 16 positions of level K each (a warp's leaf load covers whole
// 64-byte halves of lines), with K as deep as that allows, so the scratch
// and the last CTA's fold stay small (n_K / L under 1/512). Shared memory is
// dynamic: the segments or level K, whichever is longer (up to 128 KB
// for the longest rows). The wrapper allocates the scratch and zeroes
// the counters in each call, on the caller's stream; the kernel
// allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// a row is shorter than 2^31: at most 31 halving steps
constexpr int MAX_LEVELS = 31;
// the most levels a thread walks (2^4 leaf loads in flight)
constexpr int THREAD_LEVELS = 4;
// the most positions a CTA holds in shared memory (128 KB)
constexpr int SMEM_N = 32768;

}  // namespace

// Mirror of fused.SumArgs: the rows, their length, the lengths of levels
// T and K, the level-K positions a CTA owns (the row's last CTA may own
// fewer), the CTAs a row, the rows a CTA (an uncut row's CTA may pack
// several), T and j = K - T, n_k's parity as bit k, the +0.0 of
// _block_partials, and the steps h_k (k < K).
struct SumPlan {
  int64_t rows;
  int32_t length;
  int32_t nt;
  int32_t nk;
  int32_t width;
  int32_t chunks;
  int32_t pack;
  int32_t t;
  int32_t j;
  int32_t odd;
  int32_t plus_zero;
  int32_t h[MAX_LEVELS];
};

namespace {

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ q,
                                     float (&v)[V]);

template <>
__device__ __forceinline__ void load<1>(const float* __restrict__ q,
                                        float (&v)[1]) {
  v[0] = __ldg(q);
}

template <>
__device__ __forceinline__ void load<4>(const float* __restrict__ q,
                                        float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(q));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The level-B values of the V positions at q: the tree of the leaves
// q + sum of h[b] over the set bits b < B of m, in the order of m. When
// `chain` (the node lies on the last chain), lane `lane` is level T's
// last position, and its node joining the step from level B - 1 passes
// the right side on alone if that level's length is odd.
template <int B, int V>
struct Tree {
  static __device__ __forceinline__ void run(const float* __restrict__ q,
                                             const int (&h)[THREAD_LEVELS],
                                             int odd, int lane, bool chain,
                                             float (&out)[V]) {
    float left[V], right[V];
    Tree<B - 1, V>::run(q, h, odd, lane, false, left);
    Tree<B - 1, V>::run(q + h[B - 1], h, odd, lane, chain, right);
    const bool pass = chain && ((odd >> (B - 1)) & 1);
#pragma unroll
    for (int c = 0; c < V; ++c)
      out[c] = pass && c == lane ? right[c] : __fadd_rn(left[c], right[c]);
  }
};

template <int V>
struct Tree<0, V> {
  static __device__ __forceinline__ void run(const float* __restrict__ q,
                                             const int (&)[THREAD_LEVELS],
                                             int, int, bool,
                                             float (&out)[V]) {
    load<V>(q, out);
  }
};

// Rows r < nrows of buf (row r at buf + r * n) folded to their sums by
// the halving steps, into out[r] (plus +0.0 when plus_zero): every row's
// steps together in shared memory down to 32 positions, then a warp a
// row for the last five.
__device__ __forceinline__ void fold(float* buf, int n, int nrows,
                                     float* out, int plus_zero) {
  const int stride = n;
  while (n > 32) {
    const int h = n >> 1;
    // a row's position 0 reads b[h] before the carry overwrites it, and
    // is the only reader of b[h] this step
    for (int i = threadIdx.x; i < nrows * h; i += THREADS) {
      const int r = i / h;
      const int k = i - r * h;
      float* b = buf + r * stride;
      b[k] = __fadd_rn(b[k], b[k + h]);
      if (k == 0 && (n & 1)) b[h] = b[n - 1];
    }
    __syncthreads();
    n = h + (n & 1);
  }
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nrows; r += THREADS / 32) {
    float v = lane < n ? buf[r * stride + lane] : 0.0f;
    for (int m = n; m > 1; m = (m >> 1) + (m & 1)) {
      const int h = m >> 1;
      const float o = __shfl_down_sync(0xffffffffu, v, h);
      if (lane < h)
        v = __fadd_rn(v, o);
      else if (lane == h && (m & 1))
        v = o;
    }
    if (lane == 0) out[r] = plus_zero ? __fadd_rn(v, 0.0f) : v;
  }
}

template <int T, int V>
__global__ void __launch_bounds__(THREADS, 2)
    sum_kernel(const float* __restrict__ x, const __grid_constant__ SumPlan s,
               float* __restrict__ out, float* __restrict__ scratch,
               int* __restrict__ arrivals) {
  extern __shared__ __align__(16) float buf[];
  __shared__ int last;
  // a cut row's range, or `pack` whole rows
  int64_t row = blockIdx.x;
  int c = 0, nrows = 1;
  if (s.chunks > 1) {
    row = blockIdx.x / s.chunks;
    c = (int)(blockIdx.x - row * s.chunks);
  } else {
    row *= s.pack;
    nrows = (int)min((int64_t)s.pack, s.rows - row);
  }
  const int a = c * s.width;
  const int w = min(s.width, s.nk - a);
  int h[THREAD_LEVELS];
#pragma unroll
  for (int b = 0; b < THREAD_LEVELS; ++b) h[b] = b < T ? s.h[b] : 0;

  // 1. level T of the range's segments, segment g at slot rev_j(g) (j is
  // 0 where a CTA packs rows: slot r is the CTA's row r)
  const int per_seg = w / V;
  const int groups = (per_seg << s.j) * nrows;
  for (int i = threadIdx.x; i < groups; i += THREADS) {
    const int slot = i / per_seg;
    const int e = (i - slot * per_seg) * V;
    int p = a + e;
    for (int b = 0; b < s.j; ++b)
      if ((slot >> (s.j - 1 - b)) & 1) p += s.h[T + b];
    const int lane = s.nt - 1 - p;
    float v[V];
    Tree<T, V>::run(x + (row + (slot >> s.j)) * s.length + p, h, s.odd, lane,
                    lane >= 0 && lane < V, v);
    float* dst = buf + slot * w + e;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    else
      dst[0] = v[0];
  }
  __syncthreads();

  // 2. levels T .. K: the slots halve; the last chain's rule where this
  // CTA owns level K's last position
  const bool owns_last = a + w == s.nk;
  for (int b = 0, half = (1 << s.j) >> 1; half; ++b, half >>= 1) {
    const int n = half * w;
    const bool pass = owns_last && ((s.odd >> (T + b)) & 1);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float r = buf[i + n];
      buf[i] = pass && i == n - 1 ? r : __fadd_rn(buf[i], r);
    }
    __syncthreads();
  }

  // 3. the fold, by this CTA or by the row's last to arrive
  if (s.chunks > 1) {
    float* sr = scratch + row * s.nk;
    for (int i = threadIdx.x; i < w; i += THREADS) sr[a + i] = buf[i];
    // the writers make their stores visible before the ticket
    if (threadIdx.x < w) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(arrivals + row, 1) == s.chunks - 1;
      // every CTA of the row has arrived: the next launch (a graph's
      // replay) finds the counter at zero
      if (last) arrivals[row] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = threadIdx.x; i < s.nk; i += THREADS) buf[i] = __ldcg(sr + i);
    __syncthreads();
  }
  fold(buf, s.nk, nrows, out + row, s.plus_zero);
}

using Kernel = void (*)(const float*, SumPlan, float*, float*, int*);

}  // namespace

extern "C" {

void sum_kernels_layout(int* max_levels, int* thread_levels, int* smem_n,
                        int* threads) {
  *max_levels = MAX_LEVELS;
  *thread_levels = THREAD_LEVELS;
  *smem_n = SMEM_N;
  *threads = THREADS;
}

// every row's sum into out ([rows]); scratch ([rows, nk]) and arrivals
// ([rows], zero) when chunks > 1; vec 4 takes the float4 path; smem the
// dynamic shared memory (fused.sum_smem). 0 = ok, else the CUDA error.
int launch_tree_sum(const void* x, SumPlan s, int vec, int smem, void* out,
                    void* scratch, void* arrivals, void* stream) {
  const int k = s.t + s.j;
  const bool split = s.chunks > 1;
  const int64_t blocks =
      split ? s.rows * s.chunks : (s.rows + s.pack - 1) / s.pack;
  if (s.t < 0 || s.t > THREAD_LEVELS || s.j < 0 || k > MAX_LEVELS ||
      s.rows < 1 || s.chunks < 1 || s.width < 1 || s.nk < 1 ||
      s.pack < 1 || (s.pack > 1 && (split || s.j)) ||
      (int64_t)s.pack * s.nk > SMEM_N ||
      s.nk > SMEM_N || ((int64_t)s.width << s.j) > SMEM_N ||
      smem < (int64_t)4 * s.pack * s.nk ||
      smem < (int64_t)4 * s.width << s.j ||
      smem > 4 * SMEM_N ||
      (int64_t)(s.chunks - 1) * s.width >= s.nk ||
      (int64_t)s.chunks * s.width < s.nk || blocks > 0x7fffffff ||
      (split && (scratch == nullptr || arrivals == nullptr)) ||
      (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  // a row whose steps are multiples of 4 is at least 16 long: T = 4
  if (vec == 4 && (s.t != THREAD_LEVELS || s.length % 4 || s.width % 4 ||
                   s.nk % 4 || (reinterpret_cast<uintptr_t>(x) & 15)))
    return (int)cudaErrorInvalidValue;
  Kernel kern = sum_kernel<THREAD_LEVELS, 4>;
  if (vec == 1) switch (s.t) {
      case 0: kern = sum_kernel<0, 1>; break;
      case 1: kern = sum_kernel<1, 1>; break;
      case 2: kern = sum_kernel<2, 1>; break;
      case 3: kern = sum_kernel<3, 1>; break;
      default: kern = sum_kernel<4, 1>; break;
    }
  // above 48 KB a kernel takes dynamic shared memory only when allowed
  static bool wide[THREAD_LEVELS + 2];
  bool& allowed = wide[vec == 4 ? THREAD_LEVELS + 1 : s.t];
  if (smem > 48 * 1024 && !allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * SMEM_N);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  kern<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, s, (float*)out, (float*)scratch, (int*)arrivals);
  return (int)cudaGetLastError();
}

const char* sum_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
