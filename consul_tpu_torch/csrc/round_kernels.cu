// SWIM protocol-period kernels for Hopper (sm_90a), bound through ctypes.
//
// What they replace. round_kernel replaces the TPU kernel _round_kernel
// (consul_tpu/sim/pallas_round.py:439, body _block_round :144) in its
// three compiled variants: honest (stable/full), fault=True (8 per-node
// fault-plan lanes and the plan's mean link quality `mid`) and fault=True,
// byz=True (4 more byzantine lanes, a replay draw and the attack
// counters). mega_kernel replaces _mega_kernel (pallas_round.py:526). All
// run one per-node body, node_round<FAULT, BYZ, STABLE>(), which follows
// the plain PyTorch body (consul_tpu_torch/sim/round.py, _round_body) op
// for op; the honest instantiations compile the fault terms away, and
// the STABLE ones (the headline's config: no churn, slow-node model,
// stats or down_age store) the churn, slow and counter code too.
// flight_row (the kernel runner's recorded rounds) builds a flight
// recorder row from the state a round left, in one launch; its note is
// at the kernel.
//
// What bounds them. Not bytes: a round moves 28-72 B/node (8.8-22.6 us
// at 1,048,576 nodes and 3.35 TB/s), and the state (15.7 MB) even fits
// in the 50 MB L2. What bounds them is instructions per node and round:
// Philox4x32-10 (~45 integer ops a call, and Hopper has half as many
// INT32 lanes as FP32 ones), and f32 terms (divisions, logf, expf,
// exp2f, integer powers) that are the same for every node of a round.
//
// What the design does about it:
//  * one Philox call gives four draws: counter (node, slot >> 2, 0, 0)
//    under the key (seeds[r], 0) yields word slot & 3. Call 0 serves
//    churn, slow, ack and the Poisson draw; call 1 (hear, replay) runs
//    only for a node that takes one of those draws: a wrongly suspected
//    live node, or a live byzantine replay victim. In the honest
//    variants a thread's four nodes run call 0 side by side, which gives
//    the scheduler four independent chains. prng.philox_bits reproduces
//    the words on the host;
//  * the round's uniform terms are built once per block in shared memory
//    (Tables), from the same device functions the per-node code would
//    call, so every entry has the bits that code computes: derive()
//    (seven divisions and a logf), shrink(c) for every confirmation count
//    c in [0, CONF_MAX], the new suspicion length for c0 in [0, 3], and
//    in the honest variants (pf_fast, pf_slow, p_ack) by (slow_eff, lh)
//    and the four Poisson CDF thresholds of each of the four rate
//    classes (not eligible; down; up and fast; up and slow). The body
//    reads the tables; the rare paths (suspicion start, confirmation,
//    refutation, epidemic growth) compute only under their own branch.
//    The fault and byz variants keep the per-node no-ack and Poisson
//    terms, whose inputs (psend, precv, suspw, forge_ack) vary per node;
//  * wide loads: a thread takes NPT consecutive nodes (4 in the honest
//    and fault round kernels, 2 in byz and mega_kernel), so with NPT = 4
//    an int8 lane is one 4-byte access, an int16 lane 8 bytes and
//    informed (or an f32 frame lane) 16 bytes; round_kernel issues the
//    next group's state loads before the current group's arithmetic, so
//    those bytes are in flight while the body runs (the fault variants
//    load their frame lanes at the top of each group, and the byz one
//    its state too: more would spill). A group at the ragged edge, or on
//    a pointer that is not 16-byte aligned, goes node by node;
//  * a grid sized to the card: min(GRID_BLOCKS, tiles) blocks of TILE /
//    NPT threads (4 blocks on each of the H100's 132 SMs; 2 resident for
//    byz and mega) walk tiles of TILE nodes in a fixed order: block b
//    takes tiles b, b + gridDim.x, ...
//    Each thread sums its lanes in registers across its nodes; each
//    block reduces once, with warp shuffles and shared memory in a fixed
//    order, into row b of a [gridDim.x, 18] f32 table (8 population
//    scalars, then the 10 SimStats counters when stats are on): no float
//    atomics, same bits every run. cuda_round.partials_rows/_row_of give
//    the same node -> row map on the host;
//  * the 8 stale population scalars and the per-round seeds are read
//    from device memory, so a multi-round run never syncs the host;
//  * the fault variants read the kernel runner's frame in place: the
//    plan's phase rows, each lane's stride between phases and the device
//    phase (FaultArrays), so no gather of the round's lanes precedes the
//    launch;
//  * the STABLE variant (write_age == 0) never stores down_age, so a
//    dead row's age stays frozen: the TPU kernel's behaviour;
//  * detection_gate (forged acks, k-of-m corroboration) runs whenever
//    the frame is byzantine or corroboration_k > 0, honest rounds too
//    (there it depends only on `up`, so it folds into the class table).
// mega_kernel carries each thread's nodes in registers through its R
// rounds (scalars frozen for the call), reading and writing them once.
//
// Build with -fmad=false: the plain version runs each PyTorch op as its
// own rounded step, so contracting a*b+c into one FMA here would move
// the last bit of the f32 lanes away from it. Never --use_fast_math:
// expf/logf must stay the accurate library versions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TICK_MAX = 32767;
constexpr int TTL_NEVER = 32767;
constexpr int CONF_MAX = 127;
constexpr int ALIVE = 1, SUSPECT = 2, DEAD = 3, LEFT = 5;
constexpr int ALIVE_AGE = -1, SLOW_AGE = -2;
constexpr int N_SCALARS = 8;
constexpr int N_LANES = 18;
constexpr int TILE = 512;              // nodes per block step
constexpr int GRID_BLOCKS = 528;       // most blocks: 4 per SM of 132
// Per kernel: consecutive nodes per thread (a block has TILE / NPT
// threads) and the resident blocks per SM asked of ptxas (which caps
// registers at 65,536 / (MINB * TILE / NPT)). Each is the fastest shape
// measured on the H100 that ptxas fits without a spill (PERF.md, launch
// shapes): byz and mega need the registers of two nodes per thread at 2
// blocks per SM (their 528 blocks then run in two waves).
constexpr int HONEST_NPT = 4, HONEST_MINB = 4;
constexpr int FAULT_NPT = 4, FAULT_MINB = 4;
constexpr int BYZ_NPT = 2, BYZ_MINB = 2;
constexpr int MEGA_NPT = 2, MEGA_MINB = 2;
constexpr int LH_TAB = 32;             // awareness levels a table holds
constexpr int FRAME_ABI_LANES = 13;    // a fault frame's pointers (mid too)
// The flight row (consul_tpu_torch/sim/flight.py): 9 gauge columns, the
// 10 SimStats counters (detect_latency_sum at FLIGHT_LAT), 3 coordinate
// columns. Its launch: FLIGHT_THREADS threads a block, FLIGHT_NPT
// consecutive nodes a thread, at most FLIGHT_BLOCKS blocks.
constexpr int FLIGHT_GAUGES = 9, FLIGHT_STATS = 10, FLIGHT_COORDS = 3;
constexpr int FLIGHT_COLS = FLIGHT_GAUGES + FLIGHT_STATS + FLIGHT_COORDS;
constexpr int FLIGHT_LAT = 4;
constexpr int FLIGHT_THREADS = 256, FLIGHT_NPT = 4;
constexpr int FLIGHT_TILE = FLIGHT_THREADS * FLIGHT_NPT;
constexpr int FLIGHT_BLOCKS = 528;

}  // namespace

// Host-folded constants and variant switches. Field order must match
// RoundParams in consul_tpu_torch/sim/cuda_round.py.
struct RoundParams {
  int rows;             // nodes in the arrays
  float n_f;            // global population, as f32
  float inv_n;          // f32(1 / n)
  float probe_interval;
  float fail_p, leave_p, fail_leave_p, rejoin_p;
  float slow_p, slow_recover_p, slow_factor, one_minus_slow_factor;
  float p_direct, p_relay, p_tcp;
  float fanout_ticks, one_minus_loss;
  float susp_max_s, shrink_r, shrink_omr, conf_k_f;
  int awareness_max, indirect_checks, corroboration_k;
  int lifeguard, shrink_on, patience_on, churn_on, slow_on, stats_on,
      write_age;
};

// One round's fault frame: [rows] lanes and the 0-d `mid`. Field order
// must match FaultArrays in consul_tpu_torch/sim/cuda_round.py. The
// byzantine pointers are null on an honest frame. With a device `phase`
// each pointer is a lane's phase-0 row of the plan, and the round's lane
// starts phase * stride[lane] elements of the lane's type past it
// (`stride` in the pointers' order; 0 for a lane that is the round's);
// a null `phase` reads every lane as it is.
struct FaultArrays {
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
  const int64_t* phase;
  int64_t stride[FRAME_ABI_LANES];
};

// One flight row's inputs and outputs. Field order must match FlightArgs
// in consul_tpu_torch/sim/cuda_round.py.
struct FlightArgs {
  const int8_t* status;     // the post-round packed lanes, [rows]
  const int16_t* inc;
  const float* informed;
  const int16_t* age;
  const int8_t* lh;
  int rows;
  float phase_host;         // the phase column when `phase` is null
  const float* t;           // the clock, 0-d
  const int64_t* phase;     // faults.phase_at's [1] phase, or null
  const int32_t* acc;       // the run's int32 counters, [N_STATS]
  const float* acc_lat;     // and its f32 latency lane, 0-d
  int32_t* prev;            // the last-recorded snapshot of both, moved
  float* prev_lat;          //   to acc / acc_lat by the launch
  const float* coord;       // coords.coord_metrics' [3] row, or null
  float* row;               // the trace row written, [FLIGHT_COLS]
  void* partials;           // FLIGHT_BLOCKS rows of FLIGHT_SUMS_BYTES
  unsigned int* ticket;     // arrival counter, zero between launches
};

namespace {

// Philox4x32-10 on counter (node, call, 0, 0) under key (seed, 0)
__device__ __forceinline__ uint4 philox(uint32_t seed, uint32_t node,
                                        uint32_t call) {
  uint32_t c0 = node, c1 = call, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// a word's top 24 bits as a uniform in [0, 1)
__device__ __forceinline__ float u01(uint32_t word) {
  return (float)(word >> 8) * (1.0f / 16777216.0f);
}

// x**y by binary exponentiation, in XLA integer_pow's product order
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

// population-scalar terms every node of a round shares
struct Shared {
  float sbar, frac_up_elig, live_frac, e_pf_fast, e_pf_slow, probe_rate,
      scale, log_den;
};

__device__ __forceinline__ Shared derive(const float* __restrict__ scal,
                                         const RoundParams& P) {
  Shared d;
  const float n_live = scal[0], n_elig = scal[1], n_up_elig = scal[2];
  d.sbar = scal[3] / n_up_elig;
  d.frac_up_elig = n_up_elig / n_elig;
  d.live_frac = n_live / P.n_f;
  const float nl = fmaxf(n_live, 1e-9f);
  d.e_pf_fast = scal[4] / nl;
  d.e_pf_slow = scal[5] / nl;
  d.probe_rate = n_live / fmaxf(n_elig - 1.0f, 1.0f);
  d.scale = P.lifeguard ? scal[6] / scal[7] : 1.0f;
  d.log_den = logf(P.conf_k_f + 1.0f);
  return d;
}

__device__ __forceinline__ float shrink(int c, const RoundParams& P,
                                        float log_den) {
  if (!P.shrink_on) return 1.0f;
  const float frac = logf((float)c + 1.0f) / log_den;
  return fmaxf(1.0f - P.shrink_omr * frac, P.shrink_r);
}

// a new suspicion's length in ticks for c0 independent confirmations
__device__ __forceinline__ int susp_len(int c0, float scale,
                                        const Shared& D,
                                        const RoundParams& P) {
  const float timeout0 = scale * P.susp_max_s * shrink(c0, P, D.log_den);
  return (int)fminf(ceilf(timeout0 / P.probe_interval), (float)TICK_MAX);
}

// P(no ack | prober timeliness g, target timeliness gj); a fault frame
// scales direct and TCP legs by the round trip rt, relay legs by relay_m
template <bool FAULT>
__device__ __forceinline__ float noack(float g, float gj, float patience,
                                       float rt, float relay_m,
                                       const Shared& D,
                                       const RoundParams& P) {
  const float ge_i = g + (1.0f - g) * patience;
  const float ge_j = gj + (1.0f - gj) * patience;
  const float pr = ge_i * ge_j;
  const float pair2 = pr * pr;
  float p_d = P.p_direct * pair2;
  const float ge_p_slow = P.slow_factor + P.one_minus_slow_factor * patience;
  const float gps2 = ge_p_slow * ge_p_slow;
  const float e_gp4 = (1.0f - D.sbar) * 1.0f + D.sbar * (gps2 * gps2);
  float p_relay1 = D.live_frac * P.p_relay * pair2 * e_gp4;
  float p_tcp = P.p_tcp * ge_i * ge_j;
  if (FAULT) {
    p_d = p_d * rt;
    p_relay1 = p_relay1 * relay_m;
    p_tcp = p_tcp * rt;
  }
  const float p_no_relay = ipow(1.0f - p_relay1, P.indirect_checks);
  return (1.0f - p_d) * p_no_relay * (1.0f - p_tcp);
}

struct Probe {
  float pf_fast, pf_slow, p_ack;
};

// the prober side of a period: miss probabilities against fast and slow
// targets, and the ack probability
template <bool FAULT>
__device__ __forceinline__ Probe probe_terms(bool slow_eff, int lh,
                                             bool patience_on, float rt,
                                             float relay_m, const Shared& D,
                                             const RoundParams& P) {
  const float g = slow_eff ? P.slow_factor : 1.0f;
  const float patience = patience_on ? 1.0f - exp2f(-(float)lh) : 0.0f;
  Probe pr;
  pr.pf_fast = noack<FAULT>(g, 1.0f, patience, rt, relay_m, D, P);
  pr.pf_slow = noack<FAULT>(g, P.slow_factor, patience, rt, relay_m, D, P);
  const float mix = (1.0f - D.sbar) * pr.pf_fast + D.sbar * pr.pf_slow;
  pr.p_ack = D.frac_up_elig * (1.0f - mix);
  return pr;
}

__device__ __forceinline__ int binom(int m, int j) {
  int c = 1;
  for (int i = 1; i <= j; ++i) c = c * (m - j + i) / i;
  return c;
}

// faults.detection_gate for a static k: (1-af)^m on down nodes, 1 on live
// ones when k == 0; P(Binom(m, q) >= k), q = p_direct*mid*(1-af), else
// (faults._binom_tail_ge: terms j >= k in order, comb(m, j) as f32).
__device__ __forceinline__ float detection_gate(bool up, float af,
                                                float mid,
                                                const RoundParams& P) {
  const int m = P.indirect_checks;
  if (P.corroboration_k <= 0) return up ? 1.0f : ipow(1.0f - af, m);
  const float q = P.p_direct * mid * (1.0f - af);
  float total = 0.0f;
  for (int j = P.corroboration_k; j <= m; ++j)
    total = total + (float)binom(m, j) * ipow(q, j) * ipow(1.0f - q, m - j);
  return fminf(fmaxf(total, 0.0f), 1.0f);
}

// one node's view of the round's fault frame
struct FaultIn {
  float psend, precv, suspw, hear_w, crash_p, rejoin_p, leave_p, mid;
  float forge_ack, spur_susp, replay;
  bool slow_f, attacked;
};

// the target side's failed-probe arrival rate
template <bool FAULT, bool BYZ>
__device__ __forceinline__ float fail_rate(bool up, bool slow_eff,
                                           bool elig, const FaultIn& f,
                                           const Shared& D,
                                           const RoundParams& P) {
  float base_fail = slow_eff ? D.e_pf_slow : D.e_pf_fast;
  if (FAULT) base_fail = 1.0f - (1.0f - base_fail) * f.suspw;
  float p_fail = up ? base_fail : 1.0f;
  if (BYZ || P.corroboration_k > 0)
    p_fail = p_fail * detection_gate(up, BYZ ? f.forge_ack : 0.0f,
                                     FAULT ? f.mid : 1.0f, P);
  const float eligf = elig ? 1.0f : 0.0f;
  float lam = D.probe_rate * p_fail * eligf;
  if (BYZ) lam = lam + f.spur_susp * eligf;
  return lam;
}

// the four CDF terms a truncated Poisson draw (k <= 4) is compared with
__device__ __forceinline__ void poisson_cdf(float lam, float* cdf) {
  float term = expf(-lam);
  float c = term;
#pragma unroll
  for (int k = 1; k <= 4; ++k) {
    cdf[k - 1] = c;
    term = term * lam / (float)k;
    c = c + term;
  }
}

__device__ __forceinline__ int poisson_draw(float u, const float* cdf) {
  return (int)(u > cdf[0]) + (int)(u > cdf[1]) + (int)(u > cdf[2]) +
         (int)(u > cdf[3]);
}

// The round's uniform terms, built once per block (see the note above).
struct Tables {
  Shared D;
  float shrink[CONF_MAX + 1];  // shrink(c)
  int len0[4];                 // susp_len(c0)
  int n_lh;                    // awareness levels tabulated; 0: none
  float pf_fast[2][LH_TAB];    // [slow_eff][lh], honest variants
  float pf_slow[2][LH_TAB];
  float p_ack[2][LH_TAB];
  float cdf[4][4];             // [rate class][k], honest variants
};

template <bool FAULT, bool BYZ, bool STABLE, int THREADS>
__device__ __forceinline__ void build_tables(Tables& T,
                                             const float* __restrict__ scal,
                                             const RoundParams& P) {
  if (threadIdx.x == 0) T.D = derive(scal, P);
  __syncthreads();
  const Shared D = T.D;
  for (int c = threadIdx.x; c <= CONF_MAX; c += THREADS)
    T.shrink[c] = shrink(c, P, D.log_den);
  // byzantine rounds: a forged suspicion races the full Lifeguard timer
  const float scale = (BYZ && P.lifeguard) ? fmaxf(D.scale, 1.0f) : D.scale;
  if (threadIdx.x < 4)
    T.len0[threadIdx.x] = susp_len(threadIdx.x, scale, D, P);
  if (!FAULT) {
    // lh enters only through patience; without it one level serves all
    const bool patience_on = !STABLE && P.patience_on;
    const int n_lh = patience_on ? P.awareness_max + 1 : 1;
    if (threadIdx.x == 0) T.n_lh = n_lh <= LH_TAB ? n_lh : 0;
    for (int e = threadIdx.x; e < 2 * LH_TAB; e += THREADS) {
      const int se = e / LH_TAB, lh = e - se * LH_TAB;
      if (lh < n_lh) {
        const Probe pr = probe_terms<false>(se != 0, lh, patience_on,
                                            1.0f, 1.0f, D, P);
        T.pf_fast[se][lh] = pr.pf_fast;
        T.pf_slow[se][lh] = pr.pf_slow;
        T.p_ack[se][lh] = pr.p_ack;
      }
    }
    if (threadIdx.x < 4) {
      // class 0: not eligible; 1: down; 2: up and fast; 3: up and slow
      const int cls = threadIdx.x;
      const FaultIn none{};
      poisson_cdf(fail_rate<false, false>(cls >= 2, cls == 3, cls >= 1,
                                          none, D, P),
                  T.cdf[cls]);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float shrink_at(const Tables& T, int c,
                                           const RoundParams& P) {
  return (unsigned)c <= (unsigned)CONF_MAX ? T.shrink[c]
                                           : shrink(c, P, T.D.log_den);
}

struct Node {
  int status, inc, age, slen, sttl, conf, lh;
  float informed;
};

// One protocol period for one node, on the words w of its Philox call 0.
// Sets the 8 scalar lanes `sc` (post-round population terms) and ADDS
// this round's counters to acc[8..17] when stats are on (16 and 17, the
// attack counters, on byzantine rounds only).
template <bool FAULT, bool BYZ, bool STABLE>
__device__ __forceinline__ void node_round(Node& s, const RoundParams& P,
                                           const Tables& T, const Shared& D,
                                           uint32_t seed, uint32_t node,
                                           uint4 w, const FaultIn& f,
                                           float* sc, float* acc) {
  int age = s.age;
  bool up = age < 0;
  bool slow = age == SLOW_AGE;
  int status = s.status, inc = s.inc, slen = s.slen, sttl = s.sttl;
  int s_conf = s.conf, lh = s.lh;
  float informed = s.informed;
  bool new_rumor = false, crash = false, leave = false, rejoin = false;

  if (age >= 0) age = min(age + 1, TICK_MAX);

  // churn (plan churn bursts and flap schedules add to the rates)
  if (FAULT || (!STABLE && P.churn_on)) {
    const float u = u01(w.x);
    float fail_p = P.fail_p, fail_leave_p = P.fail_leave_p,
          rejoin_p = P.rejoin_p;
    if (FAULT) {
      fail_p = P.fail_p + f.crash_p;
      fail_leave_p = fail_p + (P.leave_p + f.leave_p);
      rejoin_p = P.rejoin_p + f.rejoin_p;
    }
    crash = up && (u < fail_p);
    leave = up && (u >= fail_p) && (u < fail_leave_p);
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
      informed = P.inv_n;
      sttl = TTL_NEVER;
      new_rumor = true;
    }
  }

  // degraded-node churn
  if (!STABLE && P.slow_on) {
    const float us = u01(w.y);
    slow = (slow ? (us >= P.slow_recover_p) : (us < P.slow_p)) && up;
  }
  // forced slow shapes this round only; the stored slow stays stochastic
  const bool slow_eff = FAULT ? ((slow || f.slow_f) && up) : slow;

  // prober side
  const bool elig = (status == ALIVE) || (status == SUSPECT);
  const bool patience_on =
      FAULT ? (bool)P.lifeguard : (!STABLE && P.patience_on);
  Probe pr;
  if (FAULT) {
    const float rt = f.psend * f.precv;
    pr = probe_terms<true>(slow_eff, lh, patience_on, rt, rt * f.mid, D, P);
  } else {
    const int li = patience_on ? lh : 0;
    if ((unsigned)li < (unsigned)T.n_lh) {
      const int se = slow_eff ? 1 : 0;
      pr.pf_fast = T.pf_fast[se][li];
      pr.pf_slow = T.pf_slow[se][li];
      pr.p_ack = T.p_ack[se][li];
    } else {
      pr = probe_terms<false>(slow_eff, lh, patience_on, 1.0f, 1.0f, D, P);
    }
  }
  const bool ack = up && (u01(w.z) < pr.p_ack);
  const bool failed = up && !ack;
  if (P.lifeguard)
    lh = min(max(lh + (int)failed - (int)ack, 0), P.awareness_max);

  // target side: truncated-Poisson failed-probe arrivals (k <= 4)
  int n_fail;
  if (FAULT) {
    float cdf[4];
    poisson_cdf(fail_rate<FAULT, BYZ>(up, slow_eff, elig, f, D, P), cdf);
    n_fail = poisson_draw(u01(w.w), cdf);
  } else {
    const int cls = elig ? (up ? (slow_eff ? 3 : 2) : 1) : 0;
    n_fail = poisson_draw(u01(w.w), T.cdf[cls]);
  }

  if (status == SUSPECT) sttl -= 1;
  const bool starts = (n_fail > 0) && (status == ALIVE);
  const bool confirms = (n_fail > 0) && (status == SUSPECT);
  if (starts) {
    const int c0 = n_fail - 1;
    status = SUSPECT;
    slen = T.len0[c0];
    sttl = slen;
    s_conf = c0;
    informed = P.inv_n;
    new_rumor = true;
  }
  if (confirms) {
    const int c_new = min(s_conf + n_fail, CONF_MAX);
    const float ratio = shrink_at(T, c_new, P) / shrink_at(T, s_conf, P);
    const int len2 = (int)ceilf((float)slen * ratio);
    sttl = sttl - (slen - len2);
    slen = len2;
    s_conf = c_new;
  }

  // refutation race; the hear and replay draws are words 0 and 1 of the
  // node's Philox call 1, taken only where one of them is needed
  uint4 w1 = make_uint4(0u, 0u, 0u, 0u);
  const bool wrongly =
      up && (status == SUSPECT || status == DEAD) && !new_rumor;
  bool refute = false;
  if (wrongly) {
    const float g = slow_eff ? P.slow_factor : 1.0f;
    float lam_hear = P.fanout_ticks * informed * P.one_minus_loss * g;
    if (FAULT) lam_hear = lam_hear * f.hear_w;
    if (BYZ) lam_hear = lam_hear * (1.0f - f.replay);
    const float p_hear = 1.0f - expf(-lam_hear);
    w1 = philox(seed, node, 1u);
    refute = u01(w1.x) < p_hear;
  }
  if (refute) {
    status = ALIVE;
    inc = min(inc + 1, TICK_MAX);
    informed = P.inv_n;
    sttl = TTL_NEVER;
    slen = 0;
    s_conf = 0;
    new_rumor = true;
  }
  if (P.lifeguard) lh = min(max(lh + (int)refute, 0), P.awareness_max);

  // stale replays force live victims into incarnation bumps; the draw is
  // taken only where replay > 0 on a live node (elsewhere it cannot bump)
  if (BYZ && up && f.replay > 0.0f) {
    if (!wrongly) w1 = philox(seed, node, 1u);
    const float ur = u01(w1.y);
    if (status == ALIVE && !new_rumor && ur < f.replay) {
      inc = min(inc + 1, TICK_MAX);
      informed = P.inv_n;
      new_rumor = true;
    }
  }

  // dead declaration
  const bool declare = (status == SUSPECT) && (sttl <= 0);
  if (declare) {
    status = DEAD;
    informed = P.inv_n;
    sttl = TTL_NEVER;
    new_rumor = true;
  }

  // epidemic growth
  if (!new_rumor && informed < 1.0f) {
    float lam_g = P.fanout_ticks * informed * P.one_minus_loss;
    if (FAULT) lam_g = lam_g * f.mid;
    if (BYZ) lam_g = lam_g * (1.0f - f.replay);
    informed = informed + (1.0f - informed) * (1.0f - expf(-lam_g));
  }

  s.status = status;
  s.inc = inc;
  s.informed = informed;
  // the stable variant never stores down_age, across R rounds too
  if (FAULT || (!STABLE && P.write_age))
    s.age = up ? (slow ? SLOW_AGE : ALIVE_AGE) : age;
  s.slen = slen;
  s.sttl = sttl;
  s.conf = s_conf;
  s.lh = lh;

  const float upf = up ? 1.0f : 0.0f;
  const bool elig2 = (status == ALIVE) || (status == SUSPECT);
  const float elig2f = elig2 ? 1.0f : 0.0f;
  const float w_fail = upf * (1.0f - pr.p_ack);
  sc[0] = upf;
  sc[1] = elig2f;
  sc[2] = upf * elig2f;
  sc[3] = (slow && up && elig2) ? 1.0f : 0.0f;
  sc[4] = upf * pr.pf_fast;
  sc[5] = upf * pr.pf_slow;
  sc[6] = w_fail * ((float)lh + 1.0f);
  sc[7] = w_fail;
  if (!STABLE && P.stats_on) {
    const bool tp = declare && !up;
    // a node crashing in round r ends it at age 0: (age + 1) periods
    const float lat = (float)(age + 1) * P.probe_interval;
    acc[8] += starts ? 1.0f : 0.0f;
    acc[9] += refute ? 1.0f : 0.0f;
    acc[10] += (declare && up) ? 1.0f : 0.0f;
    acc[11] += tp ? 1.0f : 0.0f;
    acc[12] += tp ? lat : 0.0f;
    acc[13] += crash ? 1.0f : 0.0f;
    acc[14] += rejoin ? 1.0f : 0.0f;
    acc[15] += leave ? 1.0f : 0.0f;
    if (BYZ) {
      acc[16] += (starts && f.attacked) ? 1.0f : 0.0f;
      acc[17] += (declare && up && f.attacked) ? 1.0f : 0.0f;
    }
  }
}

// ------------------------------------------------ groups of NPT nodes

struct Arrays {
  int8_t* status;
  int16_t* inc;
  float* informed;
  int16_t* age;
  int16_t* slen;
  int16_t* sttl;
  int8_t* conf;
  int8_t* lh;
};

// NPT consecutive values of one SIZE-byte lane, as 32-bit words
template <int NPT, int SIZE>
struct Lane {
  static constexpr int BYTES = NPT * SIZE;
  uint32_t w[(BYTES + 3) / 4];
};

// one naturally aligned access of BYTES
template <int BYTES> struct Access;
template <> struct Access<1> { using T = uint8_t; };
template <> struct Access<2> { using T = uint16_t; };
template <> struct Access<4> { using T = uint32_t; };
template <> struct Access<8> { using T = uint2; };
template <> struct Access<16> { using T = uint4; };

// `wide`: one access for the whole group (aligned and inside the rows);
// else node by node, nodes past the end left 0
template <int NPT, int SIZE>
__device__ __forceinline__ Lane<NPT, SIZE> ld(const void* base, int i,
                                              int n, bool wide) {
  using A = typename Access<NPT * SIZE>::T;
  const uint8_t* p = (const uint8_t*)base + (size_t)i * SIZE;
  Lane<NPT, SIZE> L;
  if (wide) {
    const A v = *reinterpret_cast<const A*>(p);
    if constexpr (NPT * SIZE == 16) {
      L.w[0] = v.x; L.w[1] = v.y; L.w[2] = v.z; L.w[3] = v.w;
    } else if constexpr (NPT * SIZE == 8) {
      L.w[0] = v.x; L.w[1] = v.y;
    } else {
      L.w[0] = (uint32_t)v;
    }
    return L;
  }
#pragma unroll
  for (int k = 0; k < (NPT * SIZE + 3) / 4; ++k) L.w[k] = 0u;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    if (i + j < n) {
      uint32_t v;
      if constexpr (SIZE == 1) v = p[j];
      else if constexpr (SIZE == 2) v = ((const uint16_t*)p)[j];
      else v = ((const uint32_t*)p)[j];
      L.w[(j * SIZE) / 4] |= v << (8 * ((j * SIZE) % 4));
    }
  }
  return L;
}

template <int NPT, int SIZE>
__device__ __forceinline__ void st(void* base, int i, int n, bool wide,
                                   const Lane<NPT, SIZE>& L) {
  using A = typename Access<NPT * SIZE>::T;
  uint8_t* p = (uint8_t*)base + (size_t)i * SIZE;
  if (wide) {
    A v;
    if constexpr (NPT * SIZE == 16) {
      v.x = L.w[0]; v.y = L.w[1]; v.z = L.w[2]; v.w = L.w[3];
    } else if constexpr (NPT * SIZE == 8) {
      v.x = L.w[0]; v.y = L.w[1];
    } else {
      v = (A)L.w[0];
    }
    *reinterpret_cast<A*>(p) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    if (i + j < n) {
      const uint32_t v = L.w[(j * SIZE) / 4] >> (8 * ((j * SIZE) % 4));
      if constexpr (SIZE == 1) p[j] = (uint8_t)v;
      else if constexpr (SIZE == 2) ((uint16_t*)p)[j] = (uint16_t)v;
      else ((uint32_t*)p)[j] = v;
    }
  }
}

// value j of an int8/int16 lane, sign-extended
template <int NPT, int SIZE>
__device__ __forceinline__ int geti(const Lane<NPT, SIZE>& L, int j) {
  const uint32_t v = L.w[(j * SIZE) / 4] >> (8 * ((j * SIZE) % 4));
  if constexpr (SIZE == 1) return (int)(int8_t)(uint8_t)v;
  else return (int)(int16_t)(uint16_t)v;
}

template <int NPT>
__device__ __forceinline__ float getf(const Lane<NPT, 4>& L, int j) {
  return __uint_as_float(L.w[j]);
}

// int8/int16 narrowing: every value is already clamped to TICK_MAX /
// CONF_MAX / awareness_max
template <int NPT, int SIZE>
__device__ __forceinline__ void seti(Lane<NPT, SIZE>& L, int j, int x) {
  const int sh = 8 * ((j * SIZE) % 4);
  const uint32_t mask = SIZE == 1 ? 0xFFu : 0xFFFFu;
  uint32_t& w = L.w[(j * SIZE) / 4];
  w = (w & ~(mask << sh)) | (((uint32_t)x & mask) << sh);
}

template <int NPT>
__device__ __forceinline__ void setf(Lane<NPT, 4>& L, int j, float x) {
  L.w[j] = __float_as_uint(x);
}

template <int NPT>
struct Group {
  Lane<NPT, 1> status, conf, lh;
  Lane<NPT, 2> inc, age, slen, sttl;
  Lane<NPT, 4> informed;
};

template <int NPT>
struct FaultGroup {
  Lane<NPT, 4> psend, precv, suspw, hear_w, crash_p, rejoin_p, leave_p;
  Lane<NPT, 4> forge_ack, spur_susp, replay;
  Lane<NPT, 1> slow_f, attacked;
};

template <int NPT>
__device__ __forceinline__ Group<NPT> load_group(const Arrays& a, int i,
                                                 int n, bool wide) {
  Group<NPT> g;
  g.status = ld<NPT, 1>(a.status, i, n, wide);
  g.conf = ld<NPT, 1>(a.conf, i, n, wide);
  g.lh = ld<NPT, 1>(a.lh, i, n, wide);
  g.inc = ld<NPT, 2>(a.inc, i, n, wide);
  g.age = ld<NPT, 2>(a.age, i, n, wide);
  g.slen = ld<NPT, 2>(a.slen, i, n, wide);
  g.sttl = ld<NPT, 2>(a.sttl, i, n, wide);
  g.informed = ld<NPT, 4>(a.informed, i, n, wide);
  return g;
}

template <int NPT>
__device__ __forceinline__ void store_group(const Arrays& a, int i, int n,
                                            bool wide, const Group<NPT>& g,
                                            bool write_age) {
  st(a.status, i, n, wide, g.status);
  st(a.conf, i, n, wide, g.conf);
  st(a.lh, i, n, wide, g.lh);
  st(a.inc, i, n, wide, g.inc);
  if (write_age) st(a.age, i, n, wide, g.age);
  st(a.slen, i, n, wide, g.slen);
  st(a.sttl, i, n, wide, g.sttl);
  st(a.informed, i, n, wide, g.informed);
}

template <int NPT>
__device__ __forceinline__ Node get_node(const Group<NPT>& g, int j) {
  Node s;
  s.status = geti(g.status, j);
  s.inc = geti(g.inc, j);
  s.informed = getf(g.informed, j);
  s.age = geti(g.age, j);
  s.slen = geti(g.slen, j);
  s.sttl = geti(g.sttl, j);
  s.conf = geti(g.conf, j);
  s.lh = geti(g.lh, j);
  return s;
}

template <int NPT>
__device__ __forceinline__ void put_node(Group<NPT>& g, int j,
                                         const Node& s) {
  seti(g.status, j, s.status);
  seti(g.inc, j, s.inc);
  setf(g.informed, j, s.informed);
  seti(g.age, j, s.age);
  seti(g.slen, j, s.slen);
  seti(g.sttl, j, s.sttl);
  seti(g.conf, j, s.conf);
  seti(g.lh, j, s.lh);
}

// The frame's lanes at the device phase: each pointer moved by the phase
// times its stride (0 for a null lane). The honest kernels read no
// frame, so they take it as it is.
template <bool FAULT>
__device__ __forceinline__ FaultArrays frame_at_phase(const FaultArrays& F) {
  if constexpr (!FAULT) {
    return F;
  } else {
    const int64_t ph = F.phase ? *F.phase : 0;
    FaultArrays G = F;
    G.psend += ph * F.stride[0];
    G.precv += ph * F.stride[1];
    G.suspw += ph * F.stride[2];
    G.hear_w += ph * F.stride[3];
    G.slow_f += ph * F.stride[4];
    G.crash_p += ph * F.stride[5];
    G.rejoin_p += ph * F.stride[6];
    G.leave_p += ph * F.stride[7];
    G.mid += ph * F.stride[8];
    G.forge_ack += ph * F.stride[9];
    G.spur_susp += ph * F.stride[10];
    G.replay += ph * F.stride[11];
    G.attacked += ph * F.stride[12];
    return G;
  }
}

template <bool FAULT, bool BYZ, int NPT>
__device__ __forceinline__ FaultGroup<NPT> load_fault_group(
    const FaultArrays& F, int i, int n, bool wide) {
  FaultGroup<NPT> g{};
  if (FAULT) {
    g.psend = ld<NPT, 4>(F.psend, i, n, wide);
    g.precv = ld<NPT, 4>(F.precv, i, n, wide);
    g.suspw = ld<NPT, 4>(F.suspw, i, n, wide);
    g.hear_w = ld<NPT, 4>(F.hear_w, i, n, wide);
    g.crash_p = ld<NPT, 4>(F.crash_p, i, n, wide);
    g.rejoin_p = ld<NPT, 4>(F.rejoin_p, i, n, wide);
    g.leave_p = ld<NPT, 4>(F.leave_p, i, n, wide);
    g.slow_f = ld<NPT, 1>(F.slow_f, i, n, wide);
  }
  if (BYZ) {
    g.forge_ack = ld<NPT, 4>(F.forge_ack, i, n, wide);
    g.spur_susp = ld<NPT, 4>(F.spur_susp, i, n, wide);
    g.replay = ld<NPT, 4>(F.replay, i, n, wide);
    g.attacked = ld<NPT, 1>(F.attacked, i, n, wide);
  }
  return g;
}

template <bool FAULT, bool BYZ, int NPT>
__device__ __forceinline__ FaultIn get_fault(const FaultGroup<NPT>& g,
                                             int j, float mid) {
  FaultIn f{};
  if (FAULT) {
    f.psend = getf(g.psend, j);
    f.precv = getf(g.precv, j);
    f.suspw = getf(g.suspw, j);
    f.hear_w = getf(g.hear_w, j);
    f.slow_f = geti(g.slow_f, j) != 0;
    f.crash_p = getf(g.crash_p, j);
    f.rejoin_p = getf(g.rejoin_p, j);
    f.leave_p = getf(g.leave_p, j);
    f.mid = mid;
  }
  if (BYZ) {
    f.forge_ack = getf(g.forge_ack, j);
    f.spur_susp = getf(g.spur_susp, j);
    f.replay = getf(g.replay, j);
    f.attacked = geti(g.attacked, j) != 0;
  }
  return f;
}

// Fixed-order block reduction of the lanes into partials[blockIdx.x, :].
template <int THREADS>
__device__ __forceinline__ void block_reduce(const float* lanes,
                                             int n_lanes,
                                             float* __restrict__ partials) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float warp_sums[WARPS][N_LANES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < N_LANES; ++l) {
    if (l >= n_lanes) break;
    float v = lanes[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][l] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_LANES) {
    float v = 0.0f;
    if ((int)threadIdx.x < n_lanes) {
      for (int w = 0; w < WARPS; ++w) v += warp_sums[w][threadIdx.x];
    }
    partials[(size_t)blockIdx.x * N_LANES + threadIdx.x] = v;
  }
}

// ------------------------------------------------------------- kernels

// One period. Block b walks tiles b, b + gridDim.x, ... of TILE nodes;
// each of its TILE / NPT threads takes NPT consecutive nodes of a tile.
template <bool FAULT, bool BYZ, bool STABLE, int NPT, int MINB>
__global__ void __launch_bounds__(TILE / NPT, MINB)
    round_kernel(RoundParams P, Arrays a, FaultArrays F,
                 const float* __restrict__ scal,
                 const int32_t* __restrict__ seed,
                 float* __restrict__ partials, int vec) {
  constexpr int THREADS = TILE / NPT;
  __shared__ Tables T;
  build_tables<FAULT, BYZ, STABLE, THREADS>(T, scal, P);
  const Shared D = T.D;
  const uint32_t sd = (uint32_t)seed[0];
  const FaultArrays Fp = frame_at_phase<FAULT>(F);
  const float mid = FAULT ? *Fp.mid : 1.0f;
  const bool write_age = FAULT || (!STABLE && P.write_age);
  const int n = P.rows;
  const int step = gridDim.x * TILE;
  float acc[N_LANES];
#pragma unroll
  for (int l = 0; l < N_LANES; ++l) acc[l] = 0.0f;

  // Registers cap what a thread holds at once: the honest variants
  // prefetch the next group's state and run the group's call-0 Philox
  // chains side by side; the fault variants hold the group's frame lanes
  // instead and draw node by node, and the byz one also loads its state
  // at the top of the group.
  constexpr bool PREFETCH = !BYZ;
  int i = blockIdx.x * TILE + threadIdx.x * NPT;
  Group<NPT> g{};
  if (PREFETCH && i < n) g = load_group<NPT>(a, i, n, vec && i + NPT <= n);
  for (; i < n; i += step) {
    const bool wide = vec && i + NPT <= n;
    const FaultGroup<NPT> fcur =
        load_fault_group<FAULT, BYZ, NPT>(Fp, i, n, wide);
    Group<NPT> cur;
    if (PREFETCH) {
      cur = g;
      // the next group's state is in flight while this group's body runs
      const int nx = i + step;
      if (nx < n) g = load_group<NPT>(a, nx, n, vec && nx + NPT <= n);
    } else {
      cur = load_group<NPT>(a, i, n, wide);
    }
    uint4 w[NPT];
    if (!FAULT) {
#pragma unroll
      for (int j = 0; j < NPT; ++j)
        w[j] = philox(sd, (uint32_t)(i + j), 0u);
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (i + j < n) {
        Node s = get_node(cur, j);
        const FaultIn f = get_fault<FAULT, BYZ, NPT>(fcur, j, mid);
        const uint4 wj = FAULT ? philox(sd, (uint32_t)(i + j), 0u) : w[j];
        float sc[N_SCALARS];
        node_round<FAULT, BYZ, STABLE>(s, P, T, D, sd, (uint32_t)(i + j),
                                       wj, f, sc, acc);
#pragma unroll
        for (int l = 0; l < N_SCALARS; ++l) acc[l] += sc[l];
        put_node(cur, j, s);
      }
    }
    store_group(a, i, n, wide, cur, write_age);
  }
  block_reduce<THREADS>(acc, (!STABLE && P.stats_on) ? N_LANES : N_SCALARS,
                        partials);
}

// R periods on frozen scalars. Blocks never wait on each other: each
// thread carries its nodes through all rounds in registers, reading them
// once and writing them once.
template <bool STABLE, int NPT, int MINB>
__global__ void __launch_bounds__(TILE / NPT, MINB)
    mega_kernel(RoundParams P, Arrays a, const float* __restrict__ scal,
                const int32_t* __restrict__ seeds, int rounds,
                float* __restrict__ partials, int vec) {
  constexpr int THREADS = TILE / NPT;
  __shared__ Tables T;
  build_tables<false, false, STABLE, THREADS>(T, scal, P);
  const Shared D = T.D;
  const FaultIn none{};
  const int n = P.rows;
  const int step = gridDim.x * TILE;
  float acc[N_LANES];
#pragma unroll
  for (int l = 0; l < N_LANES; ++l) acc[l] = 0.0f;

  for (int i = blockIdx.x * TILE + threadIdx.x * NPT; i < n; i += step) {
    const bool wide = vec && i + NPT <= n;
    Group<NPT> g = load_group<NPT>(a, i, n, wide);
    Node s[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) s[j] = get_node(g, j);
    for (int r = 0; r < rounds; ++r) {
      const uint32_t sd = (uint32_t)seeds[r];
      uint4 w[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) w[j] = philox(sd, (uint32_t)(i + j), 0u);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        if (i + j < n) {
          float sc[N_SCALARS];
          node_round<false, false, STABLE>(s[j], P, T, D, sd,
                                           (uint32_t)(i + j), w[j], none,
                                           sc, acc);
          // counter lanes hold the call's totals; scalar lanes the last
          // round's
          if (r == rounds - 1) {
#pragma unroll
            for (int l = 0; l < N_SCALARS; ++l) acc[l] += sc[l];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (i + j < n) put_node(g, j, s[j]);
    store_group(a, i, n, wide, g, !STABLE && P.write_age);
  }
  block_reduce<THREADS>(acc, (!STABLE && P.stats_on) ? N_LANES : N_SCALARS,
                        partials);
}

// ------------------------------------------------------------ flight row
//
// One flight-recorder row from the post-round packed state, in place of
// flight.flight_row's plain ops (~25 launches a row, a [5, N] f32 stack
// written and read back): the counterpart of the fusion XLA compiles for
// the JAX runner's recorded round. A launch reads status, incarnation,
// informed, down_age and local_health once (10 B a node), each thread
// sums its nodes in registers, each block reduces in a fixed order into
// its row of the partials, and the last block to arrive (threadfence,
// ticket) folds the partials in a fixed order and writes the whole row:
// the clock, the five means, the max, the incarnation sum, the phase,
// the counters' delta against the snapshot, which it then moves to the
// counters, and the coordinate columns. Counts, the local-health sum and
// max and the incarnation sum are exact integers; informed is summed in
// f64. A mean is its f32 sum times inv_n, as torch's mean kernel takes
// it, so every share and the local-health mean are the plain row's bits.

// A block's sums: a row of the partials, FLIGHT_SUMS_BYTES long.
struct FlightSums {
  long long inc;
  double informed;
  int up, suspect, wrong, lh, lh_max;
};
constexpr int FLIGHT_SUMS_BYTES = 40;
static_assert(sizeof(FlightSums) == FLIGHT_SUMS_BYTES,
              "the host sizes the partials by FLIGHT_SUMS_BYTES");

__device__ __forceinline__ FlightSums flight_zero() {
  return FlightSums{0, 0.0, 0, 0, 0, 0, -128};
}

__device__ __forceinline__ void flight_add(FlightSums& s, int status,
                                           int inc, float informed,
                                           int age, int lh) {
  const bool up = age < 0;
  const bool suspect = status == SUSPECT;
  s.up += up;
  s.suspect += suspect;
  s.wrong += up && (suspect || status == DEAD);
  s.lh += lh;
  s.lh_max = max(s.lh_max, lh);
  s.inc += inc;
  s.informed += (double)informed;
}

__device__ __forceinline__ void flight_join(FlightSums& s,
                                            const FlightSums& o) {
  s.inc += o.inc;
  s.informed += o.informed;
  s.up += o.up;
  s.suspect += o.suspect;
  s.wrong += o.wrong;
  s.lh += o.lh;
  s.lh_max = max(s.lh_max, o.lh_max);
}

// Fixed-order reduction over the block; thread 0 returns the block's.
__device__ FlightSums flight_block_reduce(FlightSums s) {
  constexpr int WARPS = FLIGHT_THREADS / 32;
  __shared__ FlightSums warp_sums[WARPS];
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    FlightSums o;
    o.inc = __shfl_down_sync(all, s.inc, off);
    o.informed = __shfl_down_sync(all, s.informed, off);
    o.up = __shfl_down_sync(all, s.up, off);
    o.suspect = __shfl_down_sync(all, s.suspect, off);
    o.wrong = __shfl_down_sync(all, s.wrong, off);
    o.lh = __shfl_down_sync(all, s.lh, off);
    o.lh_max = __shfl_down_sync(all, s.lh_max, off);
    flight_join(s, o);
  }
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    s = warp_sums[0];
    for (int w = 1; w < WARPS; ++w) flight_join(s, warp_sums[w]);
  }
  return s;
}

// A partials row written by another block, read through L2.
__device__ __forceinline__ FlightSums flight_load(const FlightSums* p) {
  FlightSums s;
  s.inc = __ldcg(&p->inc);
  s.informed = __ldcg(&p->informed);
  s.up = __ldcg(&p->up);
  s.suspect = __ldcg(&p->suspect);
  s.wrong = __ldcg(&p->wrong);
  s.lh = __ldcg(&p->lh);
  s.lh_max = __ldcg(&p->lh_max);
  return s;
}

__global__ void __launch_bounds__(FLIGHT_THREADS)
    flight_row(const FlightArgs A, float inv_n, int vec) {
  __shared__ bool last;
  FlightSums* partials = (FlightSums*)A.partials;
  FlightSums s = flight_zero();
  const int n = A.rows;
  const int step = gridDim.x * FLIGHT_TILE;
  for (int i = blockIdx.x * FLIGHT_TILE + threadIdx.x * FLIGHT_NPT; i < n;
       i += step) {
    if (vec && i + FLIGHT_NPT <= n) {
      const char4 st = *reinterpret_cast<const char4*>(A.status + i);
      const short4 ic = *reinterpret_cast<const short4*>(A.inc + i);
      const float4 inf = *reinterpret_cast<const float4*>(A.informed + i);
      const short4 ag = *reinterpret_cast<const short4*>(A.age + i);
      const char4 lh = *reinterpret_cast<const char4*>(A.lh + i);
      flight_add(s, st.x, ic.x, inf.x, ag.x, lh.x);
      flight_add(s, st.y, ic.y, inf.y, ag.y, lh.y);
      flight_add(s, st.z, ic.z, inf.z, ag.z, lh.z);
      flight_add(s, st.w, ic.w, inf.w, ag.w, lh.w);
    } else {
      for (int j = i; j < i + FLIGHT_NPT && j < n; ++j)
        flight_add(s, A.status[j], A.inc[j], A.informed[j], A.age[j],
                   A.lh[j]);
    }
  }
  s = flight_block_reduce(s);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    // the row is visible before the ticket is taken
    __threadfence();
    last = atomicAdd(A.ticket, 1u) == gridDim.x - 1;
    // every block has arrived: the next launch finds the counter at zero
    if (last) *A.ticket = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  FlightSums f = flight_zero();
  for (int b = threadIdx.x; b < (int)gridDim.x; b += FLIGHT_THREADS)
    flight_join(f, flight_load(partials + b));
  f = flight_block_reduce(f);
  if (threadIdx.x != 0) return;
  float* r = A.row;
  r[0] = *A.t;
  r[1] = __fmul_rn(__int2float_rn(f.up), inv_n);
  r[2] = __fmul_rn(__double2float_rn(f.informed), inv_n);
  r[3] = __fmul_rn(__int2float_rn(f.suspect), inv_n);
  r[4] = __fmul_rn(__int2float_rn(f.wrong), inv_n);
  r[5] = __fmul_rn(__int2float_rn(f.lh), inv_n);
  r[6] = __int2float_rn(f.lh_max);
  r[7] = __ll2float_rn(f.inc);
  r[8] = A.phase != nullptr ? __ll2float_rn(*A.phase) : A.phase_host;
  for (int k = 0; k < FLIGHT_STATS; ++k) {
    // int32 subtraction wraps, as torch's does
    const int32_t d = (int32_t)((uint32_t)A.acc[k] - (uint32_t)A.prev[k]);
    r[FLIGHT_GAUGES + k] = k == FLIGHT_LAT
                               ? __fsub_rn(*A.acc_lat, *A.prev_lat)
                               : __int2float_rn(d);
    A.prev[k] = A.acc[k];
  }
  *A.prev_lat = *A.acc_lat;
  for (int k = 0; k < FLIGHT_COORDS; ++k)
    r[FLIGHT_GAUGES + FLIGHT_STATS + k] =
        A.coord != nullptr ? A.coord[k] : 0.0f;
}

int grid_for(int rows) {
  const int tiles = (rows + TILE - 1) / TILE;
  return tiles < 1 ? 1 : (tiles < GRID_BLOCKS ? tiles : GRID_BLOCKS);
}

// the stable configuration, compiled on its own: no churn, slow-node
// model, stats or down_age store
bool stable_config(const RoundParams& P) {
  return !P.churn_on && !P.slow_on && !P.stats_on && !P.write_age;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

int arrays_aligned(const Arrays& a) {
  return aligned16(a.status) && aligned16(a.inc) && aligned16(a.informed) &&
         aligned16(a.age) && aligned16(a.slen) && aligned16(a.sttl) &&
         aligned16(a.conf) && aligned16(a.lh);
}

// A lane's row is 16-byte aligned at every phase when its base is and
// its stride between phases is a multiple of 16 bytes.
bool lane_aligned(const void* p, int64_t stride, int bytes) {
  return aligned16(p) && (stride * bytes) % 16 == 0;
}

int frame_aligned(const FaultArrays& F) {
  const int64_t* s = F.stride;
  return lane_aligned(F.psend, s[0], 4) && lane_aligned(F.precv, s[1], 4) &&
         lane_aligned(F.suspw, s[2], 4) && lane_aligned(F.hear_w, s[3], 4) &&
         lane_aligned(F.slow_f, s[4], 1) &&
         lane_aligned(F.crash_p, s[5], 4) &&
         lane_aligned(F.rejoin_p, s[6], 4) &&
         lane_aligned(F.leave_p, s[7], 4) &&
         lane_aligned(F.forge_ack, s[9], 4) &&
         lane_aligned(F.spur_susp, s[10], 4) &&
         lane_aligned(F.replay, s[11], 4) &&
         lane_aligned(F.attacked, s[12], 1);
}

template <bool FAULT, bool BYZ, bool STABLE, int NPT, int MINB>
void launch_round(const RoundParams& P, const Arrays& a,
                  const FaultArrays& F, const void* scal, const void* seed,
                  void* partials, int vec, void* stream) {
  round_kernel<FAULT, BYZ, STABLE, NPT, MINB>
      <<<grid_for(P.rows), TILE / NPT, 0, (cudaStream_t)stream>>>(
          P, a, F, (const float*)scal, (const int32_t*)seed,
          (float*)partials, vec);
}

template <bool STABLE, int NPT, int MINB>
void launch_mega(const RoundParams& P, const Arrays& a, const void* scal,
                 const void* seeds, int rounds, void* partials, int vec,
                 void* stream) {
  mega_kernel<STABLE, NPT, MINB>
      <<<grid_for(P.rows), TILE / NPT, 0, (cudaStream_t)stream>>>(
          P, a, (const float*)scal, (const int32_t*)seeds, rounds,
          (float*)partials, vec);
}

}  // namespace

extern "C" {

// The launch layout, for the host's partials map and reports: nodes per
// block step, most blocks, and nodes per thread of the honest, fault,
// byz and R-round kernels.
void round_kernels_layout(int* tile, int* grid_blocks, int* npt) {
  *tile = TILE;
  *grid_blocks = GRID_BLOCKS;
  npt[0] = HONEST_NPT;
  npt[1] = FAULT_NPT;
  npt[2] = BYZ_NPT;
  npt[3] = MEGA_NPT;
}

// Each launcher returns cudaGetLastError() after its launch (0 = ok).

int launch_round_kernel(RoundParams P, void* status, void* inc,
                        void* informed, void* age, void* slen, void* sttl,
                        void* conf, void* lh, const void* scal,
                        const void* seed, void* partials, void* stream) {
  Arrays a{(int8_t*)status, (int16_t*)inc,  (float*)informed,
           (int16_t*)age,   (int16_t*)slen, (int16_t*)sttl,
           (int8_t*)conf,   (int8_t*)lh};
  const int vec = arrays_aligned(a);
  if (stable_config(P))
    launch_round<false, false, true, HONEST_NPT, HONEST_MINB>(
        P, a, FaultArrays{}, scal, seed, partials, vec, stream);
  else
    launch_round<false, false, false, HONEST_NPT, HONEST_MINB>(
        P, a, FaultArrays{}, scal, seed, partials, vec, stream);
  return (int)cudaGetLastError();
}

// The fault-plan variants: byz != 0 takes the byzantine lanes too.
int launch_round_kernel_fault(RoundParams P, void* status, void* inc,
                              void* informed, void* age, void* slen,
                              void* sttl, void* conf, void* lh,
                              FaultArrays F, int byz, const void* scal,
                              const void* seed, void* partials,
                              void* stream) {
  Arrays a{(int8_t*)status, (int16_t*)inc,  (float*)informed,
           (int16_t*)age,   (int16_t*)slen, (int16_t*)sttl,
           (int8_t*)conf,   (int8_t*)lh};
  const int vec = arrays_aligned(a) && frame_aligned(F);
  if (byz)
    launch_round<true, true, false, BYZ_NPT, BYZ_MINB>(
        P, a, F, scal, seed, partials, vec, stream);
  else
    launch_round<true, false, false, FAULT_NPT, FAULT_MINB>(
        P, a, F, scal, seed, partials, vec, stream);
  return (int)cudaGetLastError();
}

int launch_mega_kernel(RoundParams P, void* status, void* inc,
                       void* informed, void* age, void* slen, void* sttl,
                       void* conf, void* lh, const void* scal,
                       const void* seeds, int rounds, void* partials,
                       void* stream) {
  Arrays a{(int8_t*)status, (int16_t*)inc,  (float*)informed,
           (int16_t*)age,   (int16_t*)slen, (int16_t*)sttl,
           (int8_t*)conf,   (int8_t*)lh};
  const int vec = arrays_aligned(a);
  if (stable_config(P))
    launch_mega<true, MEGA_NPT, MEGA_MINB>(P, a, scal, seeds, rounds,
                                           partials, vec, stream);
  else
    launch_mega<false, MEGA_NPT, MEGA_MINB>(P, a, scal, seeds, rounds,
                                            partials, vec, stream);
  return (int)cudaGetLastError();
}

// The flight row's layout, for the host's checks and its scratch: the
// row's columns, its gauge and counter columns, the latency lane's index
// among the counters, the most blocks (rows of the partials) and the
// bytes of a partials row.
void flight_row_layout(int* cols, int* gauges, int* stats, int* lat,
                       int* blocks, int* sums_bytes) {
  *cols = FLIGHT_COLS;
  *gauges = FLIGHT_GAUGES;
  *stats = FLIGHT_STATS;
  *lat = FLIGHT_LAT;
  *blocks = FLIGHT_BLOCKS;
  *sums_bytes = FLIGHT_SUMS_BYTES;
}

int launch_flight_row(FlightArgs A, void* stream) {
  if (A.rows < 1 || !A.status || !A.inc || !A.informed || !A.age || !A.lh ||
      !A.t || !A.acc || !A.acc_lat || !A.prev || !A.prev_lat || !A.row ||
      !A.partials || !A.ticket)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(A.status) && aligned16(A.inc) &&
                  aligned16(A.informed) && aligned16(A.age) &&
                  aligned16(A.lh);
  const int tiles = (A.rows + FLIGHT_TILE - 1) / FLIGHT_TILE;
  const int blocks = tiles < FLIGHT_BLOCKS ? tiles : FLIGHT_BLOCKS;
  // the factor torch's mean kernel multiplies a sum by for the plain
  // row's [5, rows] stack: f32(outputs) / numel, both rounded to f32
  const float inv_n = 5.0f / (float)(5LL * A.rows);
  flight_row<<<blocks, FLIGHT_THREADS, 0, (cudaStream_t)stream>>>(A, inv_n,
                                                                  vec);
  return (int)cudaGetLastError();
}

const char* round_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
