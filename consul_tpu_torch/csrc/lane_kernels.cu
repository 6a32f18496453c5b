// The exact lane engine's protocol period for Hopper (sm_90a), bound
// through ctypes; and the live engine's period as three stages around its
// population sums (live_round<STAGE>, at the end of the file).
//
// What it replaces. The JAX package runs the lane engine's round
// (consul_tpu/sim/round.py:766 _lane_contributions -> _round_core,
// :113-:648, in lane mode) as one jitted program, which XLA compiles
// into one elementwise fusion (or a few). The port's plain version is
// the same body as PyTorch ops (consul_tpu_torch/sim/round.py,
// _round_body(..., lane_mode=True) on stale scalars): ~380 launches a
// round. lane_round<FRAME, BYZ> is that body in one launch: per node it
// reads the 8 packed state lanes (15 B), the round's drawn slot rows
// (the one u01_global launch before it: 4-6 f32), the frame's lanes
// under FRAME (29 B; 42 B with BYZ) and the 8 stale scalars, and writes
// the 8 lanes narrowed as the plain version narrows them and the
// [N_REDUCE_LANES = 32, ..., rows] f32 contribution stack in
// registry.REDUCE_LANES order (a lane the plain body leaves None is a
// row of +0.0).
//
// Exactness. The kernel is held bit for bit to the plain body run on
// the card, so it computes what ATen's CUDA kernels compute, op by op:
//  * every f32 step rounds on its own, in the plain body's order
//    (-fmad=false: no contraction), integer powers multiply in XLA's
//    integer_pow order (ipow), the binomial tail adds its terms j >= k
//    in order;
//  * expf, logf, exp2f and ceilf are the accurate library functions
//    ATen's unary kernels call (never the __ intrinsics, never fast
//    math);
//  * a tensor divided by a Python number is, on the card, a product
//    with the f32 reciprocal ATen takes on the host
//    (div_true_kernel_cuda's CPU-scalar path): `term * lam / k` in the
//    truncated Poisson, `timeout0 / probe_interval`, `n_live / n`. The
//    host packs those reciprocals (LaneConsts.recip_*); the CPU divides,
//    and the plain twin in consul_tpu_torch/sim/lane_kernel.py carries
//    both rules. A division of two tensors divides;
//  * Python constants enter as the f32 ATen casts them to, and the
//    constants Python folds in f64 (fail_p + leave_p, 1 - slow_factor,
//    1 / n) are folded the same way and cast once (the table below);
//  * clamps propagate NaN as ATen's do; casts to int32 truncate; the
//    narrowing stores wrap as ATen's integer casts do.
//
// A grid of constants. The sweep's lanes engine runs G points at once:
// [G, N] lanes, [8, G] stale scalars, and a params.TracedParams whose
// swept constants are [G, 1] tensors. The per-point constants reach the
// kernel as a device table [G, N_COLS] (lane_kernel.table: built by the
// plain body's own expressions, so each entry has the bits the body's
// operand has: a Python float's f32 cast, an f64 fold, or a leaf's f32
// arithmetic); one point is a table of one row. Block (x, g) takes nodes
// of point g only: the point's table row and the terms its nodes share
// (derive(): the stale scalars' quotients and the Lifeguard shrink's log
// denominator) are built once a block in shared memory by the same
// device code. A swept probe interval divides (a tensor divisor); a
// swept fault_gain makes the frame [G, N] (frame_rows) and mid [G].
//
// Window mode. The lane engine runs stale_k periods on one frozen
// scalar vector and reduces once; its window's stack holds the last
// round's instantaneous rows and, with stats on, the per-node sum of
// the k rounds' counter rows (the plain loop's `pend + rows`, a left
// fold). stats_mode writes the 10 counter rows (1), adds them onto the
// stack's (2: acc + r_j, the same fold), or skips them (0);
// write_inst == 0 skips the 22 other rows, which the window's last
// round writes.
//
// Layout: one node a thread, 256 threads a block, the blocks of a point
// striding over its nodes, at most 8 blocks an SM in all. Every load and
// store is coalesced across a warp. A simple design that is right; later
// work: threefry in the kernel, the block partials of the lane
// reduction in the kernel, node-resident windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TICK_MAX = 32767;
constexpr int TTL_NEVER = 32767;
constexpr int CONF_MAX = 127;
constexpr int ALIVE = 1, SUSPECT = 2, DEAD = 3, LEFT = 5;
constexpr int ALIVE_AGE = -1, SLOW_AGE = -2;
constexpr int N_ROWS = 32;        // registry.N_REDUCE_LANES
constexpr int STATS_ROW = 8;      // lanes.STATS_SLICE: rows 8 .. 17
constexpr int GAUGE_ROW = 18;     // LANE_GAUGES, then LANE_LH_HIST
constexpr int N_HIST = 8;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// the columns of a point's row of the constant table (lane_kernel.COLUMNS)
enum Col {
  PI, FAIL, LEAVE, FAIL_LEAVE, REJOIN, SLOW, RECOVER, SF, OMSF, P_DIRECT,
  P_RELAY, P_TCP, FANOUT, OML, SMAX, SHRINK_R, SHRINK_OMR, CONF_K, AMAX,
  CORR_K, N_COLS
};

}  // namespace

// The constants the graph key fixes (the per-point ones are the table's)
// and the switches. Field order must match LaneConsts in
// consul_tpu_torch/sim/lane_kernel.py.
struct LaneConsts {
  int rows;              // nodes in all: points * row_len
  int row_len;           // nodes a point (the lanes' last dimension)
  int points;            // G
  float inv_n;           // f32(1 / n), folded in f64: what `where` writes
  float n_f;             // f32(n): n_live / n's divisor (the CPU's rule)
  float recip_n;         // 1.0f / f32(n): the card's product for it
  float recip_pi;        // 1.0f / f32(probe_interval), an unswept one
  float recip_k[4];      // 1.0f / f32(k), k = 1 .. 4 (truncated Poisson)
  int div_pi;            // a swept probe interval: divide by the table's
  int indirect_checks;
  int lifeguard, shrink_on, churn_on, slow_on;
  int gate_on;           // detection_gate without a byzantine frame
};

// One launch's tensors. Field order must match LaneIO in lane_kernel.py.
struct LaneIO {
  const int8_t* status;
  const int16_t* inc;
  const float* informed;
  const int16_t* age;
  const int16_t* slen;
  const int16_t* sttl;
  const int8_t* conf;
  const int8_t* lh;
  int8_t* o_status;
  int16_t* o_inc;
  float* o_informed;
  int16_t* o_age;
  int16_t* o_slen;
  int16_t* o_sttl;
  int8_t* o_conf;
  int8_t* o_lh;
  const float* scal;     // the stale scalars [8, G], floors applied
  const float* tab;      // the constant table [G, N_COLS]
  const float* u_churn;  // the round's slot rows (null where not drawn)
  const float* u_slow;
  const float* u_ack;
  const float* u_pois;
  const float* u_hear;
  const float* u_replay;
  float* stack;          // [N_ROWS, G, row_len]
  int stats_mode;        // 0 skip, 1 write, 2 add onto the stack's
  int write_inst;        // write the 22 instantaneous rows
  int frame_rows;        // frame lanes [G, row_len] and mid [G]
};

// One round's fault frame: [rows] lanes and the 0-d `mid` (byzantine
// pointers null on an honest frame). Field order must match FrameArrays
// in lane_kernel.py.
struct FrameArrays {
  const float* psend;
  const float* precv;
  const float* suspw;
  const float* hear_w;
  const uint8_t* slow_f;
  const float* crash_p;
  const float* rejoin_p;
  const float* leave_p;
  const float* mid;
  const float* forge_ack;
  const float* spur_susp;
  const float* replay;
  const uint8_t* attacked;
};

// One stage of a live period (live_round below). Field order must match
// LiveIO in consul_tpu_torch/sim/live_kernel.py.
struct LiveIO {
  const int8_t* status;
  const int16_t* inc;
  const float* informed;
  const int16_t* age;
  const int16_t* slen;
  const int16_t* sttl;
  const int8_t* conf;
  const int8_t* lh;
  int8_t* o_status;      // stage c: the new lanes (may be the inputs)
  int16_t* o_inc;
  float* o_informed;
  int16_t* o_age;
  int16_t* o_slen;
  int16_t* o_sttl;
  int8_t* o_conf;
  int8_t* o_lh;
  const float* tab;      // the constant table [1, N_COLS]
  const float* u_churn;  // the round's slot rows (null where not drawn)
  const float* u_slow;
  const float* u_ack;
  const float* u_pois;
  const float* u_hear;
  const float* sums[8];  // the population sums (0-d): stage a's, b's rows
  float* rows;           // stages a and b: [4, stride]
  int32_t* counts;       // stage c: [7, stride] counter rows
  float* lat;            // stage c: [stride] latency row
  long long stride;      // a row's length, padded
  int stats;             // stage c: write the counter rows
};

namespace {

// ATen's clamp_min / clamp_max / clamp on f32: NaN stays NaN
__device__ __forceinline__ float cmin_lo(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float cmax_hi(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}

// x**y by binary exponentiation, in XLA integer_pow's product order
// (faults.ipow)
__device__ __forceinline__ float ipow(float x, int y) {
  float acc = 1.0f;
  bool first = true;
  while (y > 0) {
    if (y & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

__device__ __forceinline__ int binom(int m, int j) {
  int c = 1;
  for (int i = 1; i <= j; ++i) c = c * (m - j + i) / i;
  return c;
}

// the stale scalars' terms every node of the round shares
struct Shared {
  float n_live, n_elig, n_up_elig, sbar, frac_up_elig, live_frac;
  float e_pf_fast, e_pf_slow, probe_rate, scale, log_den;
};

// point g's terms (its stale scalars scal[k * G + g])
template <bool BYZ>
__device__ __forceinline__ Shared derive(const float* __restrict__ scal,
                                         int g, const float* T,
                                         const LaneConsts& C) {
  const int G = C.points;
  Shared d;
  d.n_live = scal[g];
  d.n_elig = scal[G + g];
  d.n_up_elig = scal[2 * G + g];
  d.sbar = scal[3 * G + g] / d.n_up_elig;
  d.frac_up_elig = d.n_up_elig / d.n_elig;
  d.live_frac = d.n_live * C.recip_n;
  const float nl = cmin_lo(d.n_live, 1e-9f);
  d.e_pf_fast = scal[4 * G + g] / nl;
  d.e_pf_slow = scal[5 * G + g] / nl;
  d.probe_rate = d.n_live / cmin_lo(d.n_elig - 1.0f, 1.0f);
  float scale = 1.0f;
  if (C.lifeguard) {
    scale = scal[6 * G + g] / scal[7 * G + g];
    if (BYZ) scale = cmin_lo(scale, 1.0f);
  }
  d.scale = scale;
  d.log_den = logf(T[CONF_K] + 1.0f);
  return d;
}

// round._shrink: the Lifeguard timeout factor for c confirmations
__device__ __forceinline__ float shrink(int c, const float* T,
                                        const LaneConsts& C,
                                        float log_den) {
  if (!C.shrink_on) return 1.0f;
  const float frac = logf((float)c + 1.0f) / log_den;
  return cmin_lo(1.0f - T[SHRINK_OMR] * frac, T[SHRINK_R]);
}

// one term of round.pf_arrays' noack_given: P(no ack) against a target
// of timeliness gj, the frame's legs scaled by rt and relay_m
template <bool FRAME>
__device__ __forceinline__ float noack(float g, float gj, float patience,
                                       float rt, float relay_m,
                                       const Shared& D, const float* T,
                                       const LaneConsts& C) {
  const float ge_i = g + (1.0f - g) * patience;
  const float ge_j = gj + (1.0f - gj) * patience;
  const float pair2 = ipow(ge_i * ge_j, 2);
  float p_d = T[P_DIRECT] * pair2;
  const float ge_p_slow = T[SF] + T[OMSF] * patience;
  const float e_gp4 = (1.0f - D.sbar) * 1.0f + D.sbar * ipow(ge_p_slow, 4);
  float p_relay1 = D.live_frac * T[P_RELAY] * pair2 * e_gp4;
  float p_tcp = T[P_TCP] * ge_i * ge_j;
  if (FRAME) {
    p_d = p_d * rt;
    p_relay1 = p_relay1 * relay_m;
    p_tcp = p_tcp * rt;
  }
  const float p_no_relay = ipow(1.0f - p_relay1, C.indirect_checks);
  return (1.0f - p_d) * p_no_relay * (1.0f - p_tcp);
}

// faults.detection_gate for the point's k (a swept k's masked terms
// j < k add +0.0 to +0.0: the same sum)
__device__ __forceinline__ float detection_gate(bool up, float af,
                                                float mid, const float* T,
                                                const LaneConsts& C) {
  const int m = C.indirect_checks;
  const int k = (int)T[CORR_K];
  if (k <= 0) return up ? 1.0f : ipow(1.0f - af, m);
  const float q = T[P_DIRECT] * mid * (1.0f - af);
  float total = 0.0f;
  for (int j = k; j <= m; ++j)
    total = total + (float)binom(m, j) * ipow(q, j) * ipow(1.0f - q, m - j);
  return cmax_hi(cmin_lo(total, 0.0f), 1.0f);
}

// round._trunc_poisson at kmax = 4
__device__ __forceinline__ int trunc_poisson(float u, float lam,
                                             const LaneConsts& C) {
  float term = expf(-lam);
  float c = term;
  int nf = 0;
#pragma unroll
  for (int k = 1; k <= 4; ++k) {
    nf += (int)(u > c);
    term = term * lam * C.recip_k[k - 1];
    c = c + term;
  }
  return nf;
}

__device__ __forceinline__ float f(bool b) { return b ? 1.0f : 0.0f; }

template <bool FRAME, bool BYZ>
__global__ void __launch_bounds__(THREADS)
lane_round(const LaneConsts C, const LaneIO io, const FrameArrays fr) {
  // block (x, g): nodes of point g
  const int g = blockIdx.y;
  __shared__ Shared sh;
  __shared__ float T[N_COLS];
  if (threadIdx.x < N_COLS) T[threadIdx.x] = io.tab[g * N_COLS + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) sh = derive<BYZ>(io.scal, g, T, C);
  __syncthreads();
  const Shared D = sh;
  const int rows = C.rows;
  const int amax = (int)T[AMAX];
  const float mid = FRAME ? fr.mid[io.frame_rows ? g : 0] : 1.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < C.row_len;
       j += stride) {
    // i: the node in the [G, row_len] lanes; j: its draws' (and an
    // unswept frame's) column
    const int i = g * C.row_len + j;
    const int fi = io.frame_rows ? i : j;
    int age = io.age[i];
    bool up = age < 0;
    bool slow = age == SLOW_AGE;
    int status = io.status[i];
    int inc = io.inc[i];
    float informed = io.informed[i];
    int slen = io.slen[i];
    int sttl = io.sttl[i];
    int s_conf = io.conf[i];
    int lh = io.lh[i];
    bool new_rumor = false;
    bool crash = false, leave = false, rejoin = false;

    float psend = 1.0f, precv = 1.0f, suspw = 1.0f, hear_w = 1.0f;
    float forge_ack = 0.0f, spur_susp = 0.0f, replay = 0.0f;
    bool slow_f = false, attacked = false;
    if (FRAME) {
      psend = fr.psend[fi];
      precv = fr.precv[fi];
      suspw = fr.suspw[fi];
      hear_w = fr.hear_w[fi];
      slow_f = fr.slow_f[fi] != 0;
    }
    if (BYZ) {
      forge_ack = fr.forge_ack[fi];
      spur_susp = fr.spur_susp[fi];
      replay = fr.replay[fi];
      attacked = fr.attacked[fi] != 0;
    }

    // dead nodes age one tick per round (saturating)
    if (age >= 0) age = min(age + 1, TICK_MAX);

    // churn
    if (FRAME || C.churn_on) {
      const float u = io.u_churn[j];
      float fail_p = T[FAIL], rejoin_p = T[REJOIN], fail_leave;
      if (FRAME) {
        fail_p = T[FAIL] + fr.crash_p[fi];
        const float leave_p = T[LEAVE] + fr.leave_p[fi];
        rejoin_p = T[REJOIN] + fr.rejoin_p[fi];
        fail_leave = fail_p + leave_p;
      } else {
        fail_leave = T[FAIL_LEAVE];
      }
      crash = up && (u < fail_p);
      leave = up && (u >= fail_p) && (u < fail_leave);
      rejoin = !up && (u < rejoin_p);
      up = (up && !(crash || leave)) || rejoin;
      if (crash || leave) age = 0;
      if (rejoin) age = ALIVE_AGE;
      slow = slow && up;
      if (leave) status = LEFT;
      if (rejoin) {
        status = ALIVE;
        inc = min(inc + 1, TICK_MAX);
        lh = 0;
      }
      if (leave || rejoin) {
        informed = C.inv_n;
        sttl = TTL_NEVER;
        new_rumor = true;
      }
    }

    // degraded-node churn
    if (C.slow_on) {
      const float u_s = io.u_slow[j];
      slow = (slow ? (u_s >= T[RECOVER]) : (u_s < T[SLOW])) && up;
    }
    const bool slow_eff = FRAME ? ((slow || slow_f) && up) : slow;

    // mean-field population (stale scalars) and the prober's miss terms
    const bool elig = status == ALIVE || status == SUSPECT;
    const float eligf = f(elig);
    const float gi = slow_eff ? T[SF] : 1.0f;
    // Lifeguard patience: with the slow model or a frame
    const bool patience_on = C.lifeguard && (FRAME || C.slow_on);
    const float patience = patience_on ? 1.0f - exp2f(-(float)lh) : 0.0f;
    float rt = 1.0f, relay_m = 1.0f;
    if (FRAME) {
      rt = psend * precv;
      relay_m = rt * mid;
    }
    const float pf_fast =
        noack<FRAME>(gi, 1.0f, patience, rt, relay_m, D, T, C);
    const float pf_slow =
        noack<FRAME>(gi, T[SF], patience, rt, relay_m, D, T, C);

    // prober-side probe
    const float mix_i = (1.0f - D.sbar) * pf_fast + D.sbar * pf_slow;
    const float p_ack = D.frac_up_elig * (1.0f - mix_i);
    const bool ack = up && (io.u_ack[j] < p_ack);
    const bool failed = up && !ack;
    if (C.lifeguard) lh = min(max(lh + (int)failed - (int)ack, 0), amax);

    // target-side suspicion
    float base_fail = slow_eff ? D.e_pf_slow : D.e_pf_fast;
    if (FRAME) base_fail = 1.0f - (1.0f - base_fail) * suspw;
    float p_fail_j = up ? base_fail : 1.0f;
    if (BYZ || C.gate_on)
      p_fail_j = p_fail_j * detection_gate(up, forge_ack, mid, T, C);
    float lam_fail = D.probe_rate * p_fail_j * eligf;
    if (BYZ) lam_fail = lam_fail + spur_susp * eligf;
    const int n_fail = trunc_poisson(io.u_pois[j], lam_fail, C);

    // carried suspicion timers advance one tick
    if (status == SUSPECT) sttl = sttl - 1;

    const bool starts = n_fail > 0 && status == ALIVE;
    const bool confirms = n_fail > 0 && status == SUSPECT;
    const int c0 = max(n_fail - 1, 0);
    const float timeout0 =
        D.scale * T[SMAX] * shrink(c0, T, C, D.log_den);
    const float ticks0 = ceilf(C.div_pi ? timeout0 / T[PI]
                                        : timeout0 * C.recip_pi);
    const int len0 = (int)cmax_hi(ticks0, (float)TICK_MAX);
    if (starts) {
      status = SUSPECT;
      slen = len0;
      sttl = len0;
      s_conf = c0;
      informed = C.inv_n;
      new_rumor = true;
    }

    // existing suspicions: independent confirmations shrink the timer
    const int c_new = min(s_conf + n_fail, CONF_MAX);
    const float ratio = shrink(c_new, T, C, D.log_den) /
                        shrink(s_conf, T, C, D.log_den);
    const int len2 = (int)ceilf((float)slen * ratio);
    if (confirms) {
      sttl = sttl - (slen - len2);
      slen = len2;
      s_conf = c_new;
    }

    // refutation (the race)
    float lam_hear = T[FANOUT] * informed * T[OML] * gi;
    if (FRAME) lam_hear = lam_hear * hear_w;
    if (BYZ) lam_hear = lam_hear * (1.0f - replay);
    const float p_hear = 1.0f - expf(-lam_hear);
    const bool wrongly =
        up && (status == SUSPECT || status == DEAD) && !new_rumor;
    const bool refute = wrongly && (io.u_hear[j] < p_hear);
    if (refute) {
      status = ALIVE;
      inc = min(inc + 1, TICK_MAX);
      informed = C.inv_n;
      sttl = TTL_NEVER;
      slen = 0;
      s_conf = 0;
      new_rumor = true;
    }
    if (C.lifeguard) lh = min(max(lh + (int)refute, 0), amax);

    if (BYZ) {
      // stale replays force live victims into incarnation bumps
      const bool bump = up && status == ALIVE && !new_rumor &&
                        (io.u_replay[j] < replay);
      if (bump) {
        inc = min(inc + 1, TICK_MAX);
        informed = C.inv_n;
        new_rumor = true;
      }
    }

    // dead declaration
    const bool declare = status == SUSPECT && sttl <= 0;
    if (declare) {
      status = DEAD;
      informed = C.inv_n;
      sttl = TTL_NEVER;
      new_rumor = true;
    }
    const float lat = (float)(age + 1) * T[PI];

    // epidemic growth
    const bool grow = !new_rumor && informed < 1.0f;
    float lam_g = T[FANOUT] * informed * T[OML];
    if (FRAME) lam_g = lam_g * mid;
    if (BYZ) lam_g = lam_g * (1.0f - replay);
    const float grown = informed + (1.0f - informed) * (1.0f - expf(-lam_g));
    if (grow) informed = grown;

    const int age_out = up ? (slow ? SLOW_AGE : ALIVE_AGE) : age;
    io.o_status[i] = (int8_t)status;
    io.o_inc[i] = (int16_t)inc;
    io.o_informed[i] = informed;
    io.o_age[i] = (int16_t)age_out;
    io.o_slen[i] = (int16_t)slen;
    io.o_sttl[i] = (int16_t)sttl;
    io.o_conf[i] = (int8_t)s_conf;
    io.o_lh[i] = (int8_t)lh;

    // per-node contribution rows, post-round
    float* out = io.stack + i;
    const bool suspect = status == SUSPECT;
    const bool elig2 = status == ALIVE || suspect;
    const float upf2 = f(up);
    const float elig2f = f(elig2);
    const float lhf = (float)lh;
    if (io.write_inst) {
      const float w_fail2 = upf2 * (1.0f - p_ack);
      out[0 * (size_t)rows] = upf2;
      out[1 * (size_t)rows] = elig2f;
      out[2 * (size_t)rows] = upf2 * elig2f;
      out[3 * (size_t)rows] = f(slow_eff && up && elig2);
      out[4 * (size_t)rows] = upf2 * pf_fast;
      out[5 * (size_t)rows] = upf2 * pf_slow;
      out[6 * (size_t)rows] = w_fail2 * (lhf + 1.0f);
      out[7 * (size_t)rows] = w_fail2;
      out[(GAUGE_ROW + 0) * (size_t)rows] = upf2;
      out[(GAUGE_ROW + 1) * (size_t)rows] = informed;
      out[(GAUGE_ROW + 2) * (size_t)rows] = f(suspect);
      out[(GAUGE_ROW + 3) * (size_t)rows] =
          f(up && (suspect || status == DEAD));
      out[(GAUGE_ROW + 4) * (size_t)rows] = lhf;
      out[(GAUGE_ROW + 5) * (size_t)rows] = (float)inc;
#pragma unroll
      for (int k = 1; k <= N_HIST; ++k)
        out[(GAUGE_ROW + 5 + k) * (size_t)rows] = f(lh >= k);
    }
    if (io.stats_mode) {
      const bool tp = declare && !up;
      const float r[10] = {f(starts),
                           f(refute),
                           f(declare && up),
                           f(tp),
                           tp ? lat : 0.0f,
                           f(crash),
                           f(rejoin),
                           f(leave),
                           f(BYZ && starts && attacked),
                           f(BYZ && declare && up && attacked)};
      float* s = out + STATS_ROW * (size_t)rows;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const size_t at = k * (size_t)rows;
        s[at] = io.stats_mode == 2 ? s[at] + r[k] : r[k];
      }
    }
  }
}

// the card's SMs, asked once
int card_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <bool FRAME, bool BYZ>
int launch(const LaneConsts& c, const LaneIO& io, const FrameArrays& fr,
           cudaStream_t stream) {
  // blocks a point: its nodes, at most the card's share a point
  const int need = (c.row_len + THREADS - 1) / THREADS;
  int cap = card_sms() * BLOCKS_PER_SM / c.points;
  if (cap < 1) cap = 1;
  const dim3 grid(need < cap ? need : cap, c.points);
  lane_round<FRAME, BYZ><<<grid, THREADS, 0, stream>>>(c, io, fr);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ live period
//
// What it replaces. The JAX package's live engine (consul_tpu/sim/
// round.py:649 gossip_round -> _round_core, :113, scalars=None) is one
// jitted program, which XLA compiles into elementwise fusions between
// its population sums. The port's plain version (round._round_body with
// scalars=None: no frame, no grid) is ~420 PyTorch launches a period. It
// computes its population scalars from this period's own post-churn
// arrays, in three torch.sum stages each fed by the one before
// (_round_body's first _sums call, then the pf and the Lifeguard sums,
// both on the first's scalars). live_round<STAGE> is the body between
// them, each stage redoing the per-node steps it needs from the packed
// lanes and the drawn slot rows in registers rather than storing them:
// a stage is bound by the bytes it moves, and rereading the 15 B of
// state an agent (16 MB at 1M agents, which the 50 MB L2 holds) costs
// less than writing and reading back what an earlier stage computed.
//  a  churn and the slow model; writes the first sums' 4 rows (up,
//     eligible, up x eligible, slow, up and eligible);
//  b  a's steps, the population terms from a's sums, the prober's miss
//     terms, the ack and the Lifeguard update; writes the 4 rows of the
//     second and third sums (up x pf_fast, up x pf_slow,
//     w_fail x (lh + 1), w_fail);
//  c  b's steps and the rest of the period on all 8 sums; writes the 8
//     lanes narrowed (in place where the wrapper hands it the inputs:
//     each thread reads its node before it writes it) and, with stats,
//     the counter rows _stats_add sums (int32, and the f32 latency).
// The sums stay ATen's, one row each, as the plain body takes them, so
// the period is bit for bit the plain body's; the arithmetic follows the
// rules at the top of this file (the stale lane_round's device helpers).

// the per-node state after churn and the slow model (round._round_body's
// first two steps)
struct LiveNode {
  int age, status, inc, slen, sttl, s_conf, lh;
  float informed;
  bool up, slow, new_rumor, crash, leave, rejoin;
};

__device__ __forceinline__ LiveNode live_churn(const LiveIO& io,
                                               const float* T,
                                               const LaneConsts& C,
                                               int i) {
  LiveNode v;
  v.age = io.age[i];
  v.up = v.age < 0;
  v.slow = v.age == SLOW_AGE;
  v.status = io.status[i];
  v.inc = io.inc[i];
  v.informed = io.informed[i];
  v.slen = io.slen[i];
  v.sttl = io.sttl[i];
  v.s_conf = io.conf[i];
  v.lh = io.lh[i];
  v.new_rumor = v.crash = v.leave = v.rejoin = false;
  if (v.age >= 0) v.age = min(v.age + 1, TICK_MAX);
  if (C.churn_on) {
    const float u = io.u_churn[i];
    v.crash = v.up && (u < T[FAIL]);
    v.leave = v.up && (u >= T[FAIL]) && (u < T[FAIL_LEAVE]);
    v.rejoin = !v.up && (u < T[REJOIN]);
    v.up = (v.up && !(v.crash || v.leave)) || v.rejoin;
    if (v.crash || v.leave) v.age = 0;
    if (v.rejoin) v.age = ALIVE_AGE;
    v.slow = v.slow && v.up;
    if (v.leave) v.status = LEFT;
    if (v.rejoin) {
      v.status = ALIVE;
      v.inc = min(v.inc + 1, TICK_MAX);
      v.lh = 0;
    }
    if (v.leave || v.rejoin) {
      v.informed = C.inv_n;
      v.sttl = TTL_NEVER;
      v.new_rumor = true;
    }
  }
  if (C.slow_on) {
    const float u_s = io.u_slow[i];
    v.slow = (v.slow ? (u_s >= T[RECOVER]) : (u_s < T[SLOW])) && v.up;
  }
  return v;
}

// the live body's population terms (round._round_body's mean-field
// population, target-side suspicion and Lifeguard scale) from its sums:
// stage b reads the first four, c all eight
__device__ __forceinline__ Shared live_derive(const LiveIO& io, bool all,
                                              const float* T,
                                              const LaneConsts& C) {
  Shared d;
  d.n_live = *io.sums[0];
  d.n_elig = cmin_lo(*io.sums[1], 1.0f);
  d.n_up_elig = cmin_lo(*io.sums[2], 1e-9f);
  d.sbar = *io.sums[3] / d.n_up_elig;
  d.frac_up_elig = d.n_up_elig / d.n_elig;
  d.live_frac = d.n_live * C.recip_n;
  d.e_pf_fast = d.e_pf_slow = d.probe_rate = 0.0f;
  d.scale = 1.0f;
  d.log_den = 0.0f;
  if (all) {
    const float nl = cmin_lo(d.n_live, 1e-9f);
    d.e_pf_fast = *io.sums[4] / nl;
    d.e_pf_slow = *io.sums[5] / nl;
    d.probe_rate = d.n_live / cmin_lo(d.n_elig - 1.0f, 1.0f);
    if (C.lifeguard) d.scale = *io.sums[6] / cmin_lo(*io.sums[7], 1e-9f);
    d.log_den = logf(T[CONF_K] + 1.0f);
  }
  return d;
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS)
live_round(const LaneConsts C, const LiveIO io) {
  __shared__ Shared sh;
  __shared__ float T[N_COLS];
  if (threadIdx.x < N_COLS) T[threadIdx.x] = io.tab[threadIdx.x];
  __syncthreads();
  if (STAGE > 0 && threadIdx.x == 0) sh = live_derive(io, STAGE == 2, T, C);
  __syncthreads();
  const Shared D = sh;
  const long long S = io.stride;
  const int amax = (int)T[AMAX];
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < C.rows;
       i += stride) {
    LiveNode v = live_churn(io, T, C, i);
    bool up = v.up;
    const bool elig = v.status == ALIVE || v.status == SUSPECT;
    const float upf = f(up);
    if (STAGE == 0) {
      const float eligf = f(elig);
      io.rows[i] = upf;
      io.rows[S + i] = eligf;
      io.rows[2 * S + i] = upf * eligf;
      io.rows[3 * S + i] = f(v.slow && up && elig);
      continue;
    }

    // the prober's miss terms, the ack and the Lifeguard update
    const float gi = v.slow ? T[SF] : 1.0f;
    const bool patience_on = C.lifeguard && C.slow_on;
    const float patience = patience_on ? 1.0f - exp2f(-(float)v.lh) : 0.0f;
    const float pf_fast =
        noack<false>(gi, 1.0f, patience, 1.0f, 1.0f, D, T, C);
    const float pf_slow =
        noack<false>(gi, T[SF], patience, 1.0f, 1.0f, D, T, C);
    const float mix_i = (1.0f - D.sbar) * pf_fast + D.sbar * pf_slow;
    const float p_ack = D.frac_up_elig * (1.0f - mix_i);
    const bool ack = up && (io.u_ack[i] < p_ack);
    const bool failed = up && !ack;
    int lh = v.lh;
    if (C.lifeguard) lh = min(max(lh + (int)failed - (int)ack, 0), amax);
    if (STAGE == 1) {
      const float w_fail = upf * (1.0f - p_ack);
      io.rows[i] = upf * pf_fast;
      io.rows[S + i] = upf * pf_slow;
      io.rows[2 * S + i] = w_fail * ((float)lh + 1.0f);
      io.rows[3 * S + i] = w_fail;
      continue;
    }

    // target-side suspicion
    int status = v.status, inc = v.inc, slen = v.slen, sttl = v.sttl;
    int s_conf = v.s_conf;
    float informed = v.informed;
    bool new_rumor = v.new_rumor;
    const float base_fail = v.slow ? D.e_pf_slow : D.e_pf_fast;
    float p_fail_j = up ? base_fail : 1.0f;
    if (C.gate_on)
      p_fail_j = p_fail_j * detection_gate(up, 0.0f, 1.0f, T, C);
    const float lam_fail = D.probe_rate * p_fail_j * f(elig);
    const int n_fail = trunc_poisson(io.u_pois[i], lam_fail, C);

    // carried suspicion timers advance one tick
    if (status == SUSPECT) sttl = sttl - 1;

    const bool starts = n_fail > 0 && status == ALIVE;
    const bool confirms = n_fail > 0 && status == SUSPECT;
    const int c0 = max(n_fail - 1, 0);
    const float timeout0 =
        D.scale * T[SMAX] * shrink(c0, T, C, D.log_den);
    const float ticks0 = ceilf(timeout0 * C.recip_pi);
    const int len0 = (int)cmax_hi(ticks0, (float)TICK_MAX);
    if (starts) {
      status = SUSPECT;
      slen = len0;
      sttl = len0;
      s_conf = c0;
      informed = C.inv_n;
      new_rumor = true;
    }

    // existing suspicions: independent confirmations shrink the timer
    const int c_new = min(s_conf + n_fail, CONF_MAX);
    const float ratio = shrink(c_new, T, C, D.log_den) /
                        shrink(s_conf, T, C, D.log_den);
    const int len2 = (int)ceilf((float)slen * ratio);
    if (confirms) {
      sttl = sttl - (slen - len2);
      slen = len2;
      s_conf = c_new;
    }

    // refutation (the race)
    const float lam_hear = T[FANOUT] * informed * T[OML] * gi;
    const float p_hear = 1.0f - expf(-lam_hear);
    const bool wrongly =
        up && (status == SUSPECT || status == DEAD) && !new_rumor;
    const bool refute = wrongly && (io.u_hear[i] < p_hear);
    if (refute) {
      status = ALIVE;
      inc = min(inc + 1, TICK_MAX);
      informed = C.inv_n;
      sttl = TTL_NEVER;
      slen = 0;
      s_conf = 0;
      new_rumor = true;
    }
    if (C.lifeguard) lh = min(max(lh + (int)refute, 0), amax);

    // dead declaration
    const bool declare = status == SUSPECT && sttl <= 0;
    if (declare) {
      status = DEAD;
      informed = C.inv_n;
      sttl = TTL_NEVER;
      new_rumor = true;
    }
    const float lat = (float)(v.age + 1) * T[PI];

    // epidemic growth
    const bool grow = !new_rumor && informed < 1.0f;
    const float lam_g = T[FANOUT] * informed * T[OML];
    const float grown = informed + (1.0f - informed) * (1.0f - expf(-lam_g));
    if (grow) informed = grown;

    const int age_out = up ? (v.slow ? SLOW_AGE : ALIVE_AGE) : v.age;
    io.o_status[i] = (int8_t)status;
    io.o_inc[i] = (int16_t)inc;
    io.o_informed[i] = informed;
    io.o_age[i] = (int16_t)age_out;
    io.o_slen[i] = (int16_t)slen;
    io.o_sttl[i] = (int16_t)sttl;
    io.o_conf[i] = (int8_t)s_conf;
    io.o_lh[i] = (int8_t)lh;
    if (io.stats) {
      // STATS_FIELDS' rows but the latency and the attack counters
      const bool tp = declare && !up;
      int32_t* k = io.counts + i;
      k[0] = starts;
      k[S] = refute;
      k[2 * S] = declare && up;
      k[3 * S] = tp;
      io.lat[i] = tp ? lat : 0.0f;
      if (C.churn_on) {
        k[4 * S] = v.crash;
        k[5 * S] = v.rejoin;
        k[6 * S] = v.leave;
      }
    }
  }
}

}  // namespace

extern "C" {

// The layout the wrapper maps: contribution rows, their counter rows'
// first index, the constant table's columns, and the bytes of the three
// structs a launch takes by value.
void lane_kernels_layout(int* rows, int* stats_row, int* cols,
                         int* sizes) {
  *rows = N_ROWS;
  *stats_row = STATS_ROW;
  *cols = N_COLS;
  sizes[0] = (int)sizeof(LaneConsts);
  sizes[1] = (int)sizeof(LaneIO);
  sizes[2] = (int)sizeof(FrameArrays);
}

// One period over c.points x c.row_len nodes. frame: 0 none, 1 honest,
// 2 byzantine. Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a frame kind it does not know or a shape it
// cannot launch.
int launch_lane_round(LaneConsts c, LaneIO io, FrameArrays fr, int frame,
                      void* stream) {
  if (c.row_len <= 0 || c.points <= 0 || c.points > 65535 ||
      (long long)c.points * c.row_len != c.rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frame) {
    case 0: return launch<false, false>(c, io, fr, s);
    case 1: return launch<true, false>(c, io, fr, s);
    case 2: return launch<true, true>(c, io, fr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bytes of the struct a live stage takes besides LaneConsts.
int live_io_size() { return (int)sizeof(LiveIO); }

// One stage (0, 1, 2: a, b, c) of a live period over c.rows nodes of one
// run (c.points 1). Returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue for a stage it does not know or a shape it
// cannot launch.
int launch_live_round(LaneConsts c, LiveIO io, int stage, void* stream) {
  if (c.rows <= 0 || c.points != 1 || c.row_len != c.rows ||
      io.stride < c.rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (c.rows + THREADS - 1) / THREADS;
  const int cap = card_sms() * BLOCKS_PER_SM;
  const dim3 grid(need < cap ? need : cap);
  switch (stage) {
    case 0: live_round<0><<<grid, THREADS, 0, s>>>(c, io); break;
    case 1: live_round<1><<<grid, THREADS, 0, s>>>(c, io); break;
    case 2: live_round<2><<<grid, THREADS, 0, s>>>(c, io); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* lane_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
