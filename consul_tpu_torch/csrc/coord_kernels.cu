// The Vivaldi coordinate round for Hopper (sm_90a), bound through ctypes.
//
// What they replace. No TPU kernel: the JAX package runs the coordinate
// round (consul_tpu/sim/coords.py vivaldi_step, estimate_rtt;
// consul_tpu/sim/topology.py true_rtt, sample_rtt; the coordinate branch
// of consul_tpu/sim/round.py _round_core) as XLA fusions. The port ran it
// as plain PyTorch, where every coords.vec[..., j, :], topo.pos[i] and
// adj_samples[..., idx, :] is an advanced index that ATen serves with
// one thread block a row (~15 row gathers a period, ~630 us each at
// 1,048,576 agents), plus a dozen element gathers and ~150 elementwise
// launches around them. Three launches take their place:
//
//  * coord_probe  — each agent's observed round trip to its probe target
//    pair_j[i] (the truth from the latency map times exp(sigma z)) and,
//    with RTT-aware deadlines, whether it beat its deadline (timely) and
//    the chance that a random prober q_in[i]'s deadline loses to this
//    agent's jittered round trip (late_in, 1 - ndtr(z) as the plain body
//    computes it);
//  * vivaldi_relax — vivaldi_step's full form: the spring, error, height,
//    gravity, the adjustment ring and the upd merge, with the relaxation
//    gate ack & up[pair_j] read here; each agent's moved distance (the
//    round's drift). It writes a new state out of place: the update is
//    Jacobi, every agent reads its target's old row;
//  * coord_quality — the relative error |estimate - truth| / truth of
//    every agent's probe pair on the relaxed coordinates (the sort and
//    the percentiles stay PyTorch).
//
// A grid of G points (blockIdx.y) shares the pairs, the draws and the
// latency map; each point has its own coordinate rows and lanes.
//
// What bounds them. Bytes: the agent's own rows read coalesced (the
// [N, 8] position, the [N, 20] ring as five 16-byte loads a row), its
// target's rows once each, in place, a 32-byte sector a scattered read.
// ~200 / ~330 / ~130 B an agent, 0.2-0.35 GB a launch at 2^20 agents
// (costmodel.coord_bound). Nothing is staged in shared memory: a row is
// read once by the one thread that uses it.
//
// Arithmetic. Op for op the plain PyTorch versions (coords.py
// probe_plain, vivaldi_step_plain, quality_plain) in f32, built with
// -fmad=false so every product and sum rounds on its own, as ATen's
// separate launches do; a division by a Python number is a product with
// its f32 reciprocal, as ATen divides by a CPU scalar on the card. The
// row sums take ATen's order for a reduction over a short contiguous
// last dimension (one warp-shuffle tree over the largest power of two
// that fits, each lane first adding its element to the one a tree's
// width further on, the tree halving): ((x0 + x4) + (x2 + x6)) +
// ((x1 + x5) + (x3 + x7)) for 8 terms, (x0 + x2) + (x1 + x3) for the
// 4-dimensional latency map, and for the 20-slot ring the 16-lane tree
// whose first four lanes hold x_t + x_{t+16}. With these orders every
// output is the plain version's bit for bit on the card (torch 2.11,
// CUDA 12.8; the tests hold it, tests/test_torch_coord_kernel.py); a
// build whose reduction took another order would differ by an ulp or
// so in a sum, and more in what cancels after it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DIMS = 8;           // coords.DIMENSION
constexpr int WINDOW = 20;        // coords.ADJUSTMENT_WINDOW
constexpr int MAX_TOPO_DIMS = 8;  // the latency map's dimensions, at most:
                                  // a map row is held in registers
constexpr int THREADS = 256;

// Python floats as ATen casts them for an f32 operand: from the double
constexpr float ERROR_MAX = 1.5f;
constexpr float CE = 0.25f;
constexpr float CC = 0.25f;
constexpr float HEIGHT_MIN = (float)1e-5;
constexpr float ZERO_THRESHOLD = (float)1e-6;
// x / 150.0 and x / (2 * WINDOW) as ATen divides by a CPU scalar on the
// card: a product with the f32 reciprocal
constexpr float RCP_RHO = 1.0f / 150.0f;
constexpr float RCP_TWO_WINDOW = 1.0f / 40.0f;

}  // namespace

// One launch's arguments; mirrored by coord_kernel.ProbeArgs,
// RelaxArgs and QualityArgs (ctypes), field for field.
struct ProbeArgs {
  const float* pos;         // [N, topo_dims] latency map
  const float* theight;     // [N]
  const float* sigma;       // 0-d jitter sigma
  const int32_t* pair_j;    // [N]
  const float* z;           // [N] jitter normal
  const int32_t* q_in;      // [N] random prober, or null (no deadlines)
  const float* vec;         // [G, N, DIMS]
  const float* height;      // [G, N]
  const float* adjustment;  // [G, N]
  const int32_t* lh;        // [G, N] local health
  const float* mult_g;      // [G] or null: the scalar below
  const float* interval_g;
  const float* timeout_g;
  float* rtt_obs;           // [N]
  uint8_t* timely;          // [G, N]
  float* late_in;           // [G, N]
  long long n;
  int points;
  int topo_dims;
  float mult, interval, timeout;
};

struct RelaxArgs {
  const float* vec;         // [G, N, DIMS]
  const float* error;       // [G, N]
  const float* height;      // [G, N]
  const float* samples;     // [G, N, WINDOW]
  const int32_t* adj_idx;   // [G, N]
  const int32_t* pair_j;    // [N]
  const float* rtt;         // [N]
  const float* u_dir;       // [N * DIMS] direction uniforms
  const uint8_t* ack;       // [G, N] or null: every agent acked
  const uint8_t* up;        // [G, N] or null: no gate on the target
  float* o_vec;
  float* o_error;
  float* o_height;
  float* o_adjustment;
  float* o_samples;
  int32_t* o_adj_idx;
  uint8_t* relaxed;         // [G, N] ack & up[pair_j]
  float* moved;             // [G, N]
  long long n;
  int points;
};

struct QualityArgs {
  const float* pos;
  const float* theight;
  const int32_t* pair_j;
  const float* vec;
  const float* height;
  const float* adjustment;
  float* rel;               // [G, N]
  long long n;
  int points;
  int topo_dims;
};

namespace {

// ATen's clamp_min / clamp_max by a scalar: a NaN passes through.
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v > hi ? hi : v;
}

__host__ __device__ constexpr int floor_pow2(int d) {
  return d < 2 ? 1 : 2 * floor_pow2(d / 2);
}

// ATen's sum over a contiguous last dimension of D <= 32 terms: lane t
// holds (0 + x_t) + (0 + x_{t + W}) (W the largest power of two <= D;
// its thread reduce's other accumulators are the identity, 0), then a
// shuffle-down tree over the W lanes that halves: lane t adds lane
// t + W / 2, then t + W / 4, ..., then t + 1.
template <int D>
__device__ __forceinline__ float row_sum(const float* x) {
  constexpr int W = floor_pow2(D);
  float v[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    float a = 0.0f + x[t];
    if (t + W < D) a = a + (0.0f + x[t + W]);
    v[t] = (a + 0.0f) + 0.0f;
  }
#pragma unroll
  for (int off = W / 2; off >= 1; off /= 2)
#pragma unroll
    for (int t = 0; t < off; ++t) v[t] = v[t] + v[t + off];
  return v[0];
}

__device__ __forceinline__ void load_row8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store_row8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// row_sum<D>'s order for the latency map's d <= MAX_TOPO_DIMS dimensions,
// d known at run time: the same fold onto w = floor_pow2(d) lanes and the
// same halving tree, every index unrolled (so the row stays in registers)
// and each step taken where d asks for it
__device__ __forceinline__ float map_row_sum(const float* x, int d) {
  const int w = d >= 8 ? 8 : d >= 4 ? 4 : d >= 2 ? 2 : 1;
  float v[MAX_TOPO_DIMS];
#pragma unroll
  for (int t = 0; t < MAX_TOPO_DIMS; ++t) v[t] = 0.0f + x[t];
#pragma unroll
  for (int s = 1; s < MAX_TOPO_DIMS; s *= 2)
#pragma unroll
    for (int t = 0; t < s; ++t)
      if (w == s && t + s < d) v[t] = v[t] + (0.0f + x[t + s]);
#pragma unroll
  for (int t = 0; t < MAX_TOPO_DIMS; ++t) v[t] = (v[t] + 0.0f) + 0.0f;
#pragma unroll
  for (int off = MAX_TOPO_DIMS / 2; off >= 1; off /= 2)
#pragma unroll
    for (int t = 0; t < off; ++t)
      if (off < w) v[t] = v[t] + v[t + off];
  return v[0];
}

// topology.true_rtt(i, j): ||pos_i - pos_j|| + h_i + h_j, on a latency
// map of td dimensions
__device__ __forceinline__ float true_rtt(const float* pos, const float* th,
                                          int td, long long i, long long j) {
  float d2[MAX_TOPO_DIMS];
#pragma unroll
  for (int k = 0; k < MAX_TOPO_DIMS; ++k) {
    const float d = k < td ? pos[i * td + k] - pos[j * td + k] : 0.0f;
    d2[k] = d * d;
  }
  return (sqrtf(map_row_sum(d2, td)) + th[i]) + th[j];
}

// coords._row_distance of two loaded rows
__device__ __forceinline__ float row_distance(const float* va, float ha,
                                              const float* vb, float hb) {
  float d2[DIMS];
#pragma unroll
  for (int k = 0; k < DIMS; ++k) {
    const float d = va[k] - vb[k];
    d2[k] = d * d;
  }
  return (sqrtf(row_sum<DIMS>(d2)) + ha) + hb;
}

// coords.estimate_rtt of one point's rows a, b
__device__ __forceinline__ float estimate(const float* vec, const float* h,
                                          const float* adj, long long a,
                                          long long b) {
  float va[DIMS], vb[DIMS];
  load_row8(vec + a * DIMS, va);
  load_row8(vec + b * DIMS, vb);
  const float dist = row_distance(va, h[a], vb, h[b]);
  const float adjusted = (dist + adj[a]) + adj[b];
  return adjusted > 0.0f ? adjusted : dist;
}

// the probe deadline: max(timeout, min(mult * est, interval)) * (lh + 1)
__device__ __forceinline__ float deadline(float est, int32_t lh, float mult,
                                          float interval, float timeout) {
  return clamp_lo(clamp_hi(est * mult, interval), timeout) *
         ((float)lh + 1.0f);
}

__global__ void __launch_bounds__(THREADS)
coord_probe(ProbeArgs A) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int g = blockIdx.y;
  if (i >= A.n) return;
  const long long j = A.pair_j[i];
  const float base = true_rtt(A.pos, A.theight, A.topo_dims, i, j);
  const float rtt = base * expf(A.sigma[0] * A.z[i]);
  if (g == 0) A.rtt_obs[i] = rtt;
  if (!A.q_in) return;
  const float mult = A.mult_g ? A.mult_g[g] : A.mult;
  const float interval = A.interval_g ? A.interval_g[g] : A.interval;
  const float timeout = A.timeout_g ? A.timeout_g[g] : A.timeout;
  const long long off = (long long)g * A.n;
  const float* vec = A.vec + off * DIMS;
  const float* h = A.height + off;
  const float* adj = A.adjustment + off;
  const int32_t* lh = A.lh + off;
  const float est = estimate(vec, h, adj, i, j);
  A.timely[off + i] =
      rtt <= deadline(est, lh[i], mult, interval, timeout) ? 1 : 0;
  // the target side: a random prober q's deadline against this agent's
  // round trip, 1 - Phi(ln(d / rtt) / sigma)
  const long long q = A.q_in[i];
  const float rtt_in = true_rtt(A.pos, A.theight, A.topo_dims, q, i);
  const float dl_in =
      deadline(estimate(vec, h, adj, q, i), lh[q], mult, interval, timeout);
  const float sig = clamp_lo(A.sigma[0], (float)1e-6);
  const float zz = logf(clamp_lo(dl_in, (float)1e-9) /
                        clamp_lo(rtt_in, (float)1e-9)) / sig;
  // torch.special.ndtr: (1 + erf(z * M_SQRT1_2)) * 0.5
  const float ndtr =
      (1.0f + erff(zz * (float)0.707106781186547524400844362104849039)) *
      0.5f;
  A.late_in[off + i] = 1.0f - ndtr;
}

__global__ void __launch_bounds__(THREADS)
vivaldi_relax(RelaxArgs A) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int g = blockIdx.y;
  if (i >= A.n) return;
  const long long off = (long long)g * A.n;
  const long long row = off + i;
  const long long jrow = off + A.pair_j[i];
  const float rtt = A.rtt[i];
  bool relaxed = A.ack ? A.ack[row] != 0 : true;
  if (A.up) relaxed = relaxed && A.up[jrow] != 0;
  A.relaxed[row] = relaxed ? 1 : 0;
  const bool upd = relaxed && rtt > 0.0f;
  const float rtt_safe = clamp_lo(rtt, (float)1e-12);

  float vi[DIMS], vj[DIMS], diff[DIMS], d2[DIMS];
  load_row8(A.vec + row * DIMS, vi);
  load_row8(A.vec + jrow * DIMS, vj);
  const float hi = A.height[row], hj = A.height[jrow];
  const float ei = A.error[row], ej = A.error[jrow];
#pragma unroll
  for (int k = 0; k < DIMS; ++k) {
    diff[k] = vi[k] - vj[k];
    d2[k] = diff[k] * diff[k];
  }
  const float mag = sqrtf(row_sum<DIMS>(d2));
  const float dist = (mag + hi) + hj;
  const float err = clamp_lo(ei + ej, ZERO_THRESHOLD);
  const float weight = ei / err;
  const float rel_err = fabsf(dist - rtt_safe) / rtt_safe;
  const float ce_w = weight * CE;
  const float new_error =
      clamp_hi((rel_err * CE) * weight + ei * (1.0f - ce_w), ERROR_MAX);
  const float force = (weight * CC) * (rtt_safe - dist);

  // unit vector away from j; coincident points take a random one
  const bool coincident = mag <= ZERO_THRESHOLD;
  const float safe_mag = coincident ? 1.0f : mag;
  float unit[DIMS];
  if (coincident) {
    float rv[DIMS], r2[DIMS];
    load_row8(A.u_dir + i * DIMS, rv);
#pragma unroll
    for (int k = 0; k < DIMS; ++k) {
      rv[k] = rv[k] - 0.5f;
      r2[k] = rv[k] * rv[k];
    }
    const float rmag = sqrtf(row_sum<DIMS>(r2));
    const float den = rmag > 0.0f ? rmag : 1.0f;
#pragma unroll
    for (int k = 0; k < DIMS; ++k) unit[k] = rv[k] / den;
  } else {
#pragma unroll
    for (int k = 0; k < DIMS; ++k) unit[k] = diff[k] / safe_mag;
  }
  float nv[DIMS];
#pragma unroll
  for (int k = 0; k < DIMS; ++k) {
    const float x = vi[k] + unit[k] * force;
    // gravity toward the origin: x - (x / rho)^3, the cube multiplied as
    // faults.ipow multiplies it
    const float s = x * RCP_RHO;
    nv[k] = x - s * (s * s);
  }
  const float new_height =
      coincident ? hi
                 : clamp_lo(((hi + hj) * force) / safe_mag + hi, HEIGHT_MIN);

  // adjustment ring: the residual against the moved coordinate
  const float sample = rtt_safe - row_distance(nv, new_height, vj, hj);
  float ring[WINDOW];
  const float4* src =
      reinterpret_cast<const float4*>(A.samples + row * WINDOW);
#pragma unroll
  for (int q = 0; q < WINDOW / 4; ++q) {
    const float4 v = src[q];
    ring[4 * q] = v.x; ring[4 * q + 1] = v.y;
    ring[4 * q + 2] = v.z; ring[4 * q + 3] = v.w;
  }
  const int32_t idx = A.adj_idx[row];
#pragma unroll
  for (int w = 0; w < WINDOW; ++w)
    if (upd && w == idx) ring[w] = sample;
  float4* dst = reinterpret_cast<float4*>(A.o_samples + row * WINDOW);
#pragma unroll
  for (int q = 0; q < WINDOW / 4; ++q)
    dst[q] = make_float4(ring[4 * q], ring[4 * q + 1], ring[4 * q + 2],
                         ring[4 * q + 3]);
  A.o_adjustment[row] = row_sum<WINDOW>(ring) * RCP_TWO_WINDOW;
  // (adj_idx + 1) % WINDOW with the sign of the divisor, as torch's %
  int32_t next = (idx + 1) % WINDOW;
  if (next < 0) next += WINDOW;
  A.o_adj_idx[row] = upd ? next : idx;

  float out[DIMS];
#pragma unroll
  for (int k = 0; k < DIMS; ++k) out[k] = upd ? nv[k] : vi[k];
  store_row8(A.o_vec + row * DIMS, out);
  A.o_error[row] = upd ? new_error : ei;
  A.o_height[row] = upd ? new_height : hi;
#pragma unroll
  for (int k = 0; k < DIMS; ++k) {
    const float d = out[k] - vi[k];
    d2[k] = d * d;
  }
  A.moved[row] = sqrtf(row_sum<DIMS>(d2));
}

__global__ void __launch_bounds__(THREADS)
coord_quality(QualityArgs A) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int g = blockIdx.y;
  if (i >= A.n) return;
  const long long off = (long long)g * A.n;
  const long long j = A.pair_j[i];
  const float est = estimate(A.vec + off * DIMS, A.height + off,
                             A.adjustment + off, i, j);
  const float truth = true_rtt(A.pos, A.theight, A.topo_dims, i, j);
  A.rel[off + i] = fabsf(est - truth) / clamp_lo(truth, (float)1e-9);
}

dim3 grid_of(long long n, int points) {
  return dim3((unsigned)((n + THREADS - 1) / THREADS), (unsigned)points);
}

bool shape_ok(long long n, int points) {
  return n >= 1 && points >= 1 && points <= 65535 &&
         (n + THREADS - 1) / THREADS <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The constants and struct sizes, for the host's layout checks.
void coord_kernels_layout(int* dims, int* window, int* max_topo_dims,
                          int* threads, int* probe_bytes, int* relax_bytes,
                          int* quality_bytes) {
  *dims = DIMS;
  *window = WINDOW;
  *max_topo_dims = MAX_TOPO_DIMS;
  *threads = THREADS;
  *probe_bytes = (int)sizeof(ProbeArgs);
  *relax_bytes = (int)sizeof(RelaxArgs);
  *quality_bytes = (int)sizeof(QualityArgs);
}

int launch_coord_probe(ProbeArgs A, void* stream) {
  if (!shape_ok(A.n, A.points) || A.topo_dims < 1 ||
      A.topo_dims > MAX_TOPO_DIMS || !A.pos || !A.theight || !A.sigma ||
      !A.pair_j || !A.z || !A.rtt_obs ||
      (A.q_in && (!A.vec || !A.height || !A.adjustment || !A.lh ||
                  !A.timely || !A.late_in)))
    return (int)cudaErrorInvalidValue;
  coord_probe<<<grid_of(A.n, A.points), THREADS, 0,
                (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

int launch_vivaldi_relax(RelaxArgs A, void* stream) {
  if (!shape_ok(A.n, A.points) || !A.vec || !A.error || !A.height ||
      !A.samples || !A.adj_idx || !A.pair_j || !A.rtt || !A.u_dir ||
      !A.o_vec || !A.o_error || !A.o_height || !A.o_adjustment ||
      !A.o_samples || !A.o_adj_idx || !A.relaxed || !A.moved)
    return (int)cudaErrorInvalidValue;
  vivaldi_relax<<<grid_of(A.n, A.points), THREADS, 0,
                  (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

int launch_coord_quality(QualityArgs A, void* stream) {
  if (!shape_ok(A.n, A.points) || A.topo_dims < 1 ||
      A.topo_dims > MAX_TOPO_DIMS || !A.pos || !A.theight || !A.pair_j ||
      !A.vec || !A.height || !A.adjustment || !A.rel)
    return (int)cudaErrorInvalidValue;
  coord_quality<<<grid_of(A.n, A.points), THREADS, 0,
                  (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

const char* coord_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
