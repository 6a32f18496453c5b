// SWIM protocol-period kernels for Hopper (sm_90a), bound through ctypes.
//
// round_kernel replaces the TPU kernel _round_kernel
// (consul_tpu/sim/pallas_round.py:439, body _block_round :144) in its
// three compiled variants: honest (stable/full), fault=True (8 per-node
// fault-plan lanes and the plan's mean link quality `mid`) and
// fault=True, byz=True (4 more byzantine lanes, a replay draw and the
// attack counters). mega_kernel replaces _mega_kernel
// (pallas_round.py:526). All run one per-node body, node_round<FAULT,
// BYZ>(), which follows the plain PyTorch body
// (consul_tpu_torch/sim/round.py, _round_body) op for op; the honest
// instantiation (FAULT = BYZ = false) compiles the fault terms away.
//
// Design:
//  * one thread per node, 256 threads per block, a 1-D grid over
//    ceil(rows / 256) blocks; the ragged edge is masked and padded nodes
//    contribute nothing to the sums;
//  * int8/int16 lanes widen to int32 in registers on load and narrow on
//    store (every value is already clamped to TICK_MAX / CONF_MAX);
//  * randomness: Philox4x32-10 keyed by (seeds[r], 0) on counter
//    (global node index, draw slot, 0, 0), output word 0, converted to a
//    uniform with its top 24 bits — so the draws do not depend on the
//    block size, and prng.philox_bits reproduces them on the host;
//  * the 8 stale population scalars and the per-round seeds are read
//    from device memory, so a multi-round run never syncs the host;
//  * each block reduces its 18 partial-sum lanes (8 population scalars,
//    then the 10 SimStats counters when stats are on) with warp shuffles
//    and shared memory in a fixed order and writes one row of a
//    [blocks, 18] f32 table: no float atomics, same bits every run;
//  * the STABLE variant (write_age == 0) never stores down_age, so a
//    dead row's age stays frozen — the TPU kernel's behaviour;
//  * fault lanes are plain per-node loads beside the state loads (the
//    bool masks read as uint8); `mid` is read from device memory like
//    the scalars. A fault round always draws churn and always writes
//    down_age. The byzantine replay draw is Philox slot 5, taken only
//    where it can matter (replay > 0 on a live node);
//  * detection_gate (forged acks, k-of-m corroboration) runs whenever
//    the frame is byzantine or corroboration_k > 0, honest rounds too.
//
// Bound: bandwidth. Per round at n nodes the stable variant reads
// 15 B/node and writes 13 B/node (28 B/node, 29,360,128 B at 1,048,576
// nodes, 8.76 us at 3.35 TB/s); the full variant also writes down_age
// (30 B/node); the fault variant reads 29 B/node of frame on top (59
// B/node, 18.47 us), the byzantine one 42 (72 B/node, 22.54 us).
// mega_kernel moves the same bytes once per call of R rounds, which
// leaves it bound by its arithmetic (2 to 5 Philox draws of 10 rounds
// each per node and round, plus the protocol math).
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
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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
// byzantine pointers are null on an honest frame.
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
};

namespace {

__device__ __forceinline__ uint32_t philox_word0(uint32_t seed,
                                                 uint32_t node,
                                                 uint32_t slot) {
  uint32_t c0 = node, c1 = slot, c2 = 0u, c3 = 0u;
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
  return c0;
}

__device__ __forceinline__ float u01(uint32_t seed, uint32_t node,
                                     uint32_t slot) {
  return (float)(philox_word0(seed, node, slot) >> 8) *
         (1.0f / 16777216.0f);
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

struct Node {
  int status, inc, age, slen, sttl, conf, lh;
  float informed;
};

// one node's view of the round's fault frame
struct FaultIn {
  float psend, precv, suspw, hear_w, crash_p, rejoin_p, leave_p, mid;
  float forge_ack, spur_susp, replay;
  bool slow_f, attacked;
};

// One protocol period for one node. Sets the 8 scalar lanes of `lanes`
// (post-round population terms) and ADDS this round's counters to lanes
// 8..17 when stats are on (16 and 17, the attack counters, on byzantine
// rounds only).
template <bool FAULT, bool BYZ>
__device__ __forceinline__ void node_round(Node& s, const RoundParams& P,
                                           const Shared& D, uint32_t seed,
                                           uint32_t node, const FaultIn& f,
                                           float* lanes) {
  int age = s.age;
  bool up = age < 0;
  bool slow = age == SLOW_AGE;
  int status = s.status, inc = s.inc, slen = s.slen, sttl = s.sttl;
  int s_conf = s.conf, lh = s.lh;
  float informed = s.informed;
  bool new_rumor = false, crash = false, leave = false, rejoin = false;

  if (age >= 0) age = min(age + 1, TICK_MAX);

  // churn (plan churn bursts and flap schedules add to the rates)
  if (FAULT || P.churn_on) {
    const float u = u01(seed, node, 0);
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
  if (P.slow_on) {
    const float us = u01(seed, node, 1);
    slow = (slow ? (us >= P.slow_recover_p) : (us < P.slow_p)) && up;
  }
  // forced slow shapes this round only; the stored slow stays stochastic
  const bool slow_eff = FAULT ? ((slow || f.slow_f) && up) : slow;

  // prober side
  const bool elig = (status == ALIVE) || (status == SUSPECT);
  const float g = slow_eff ? P.slow_factor : 1.0f;
  const bool patience_on = FAULT ? (bool)P.lifeguard : (bool)P.patience_on;
  const float patience = patience_on ? 1.0f - exp2f(-(float)lh) : 0.0f;
  float rt = 1.0f, relay_m = 1.0f;
  if (FAULT) {
    rt = f.psend * f.precv;
    relay_m = rt * f.mid;
  }
  const float pf_fast = noack<FAULT>(g, 1.0f, patience, rt, relay_m, D, P);
  const float pf_slow =
      noack<FAULT>(g, P.slow_factor, patience, rt, relay_m, D, P);
  const float mix = (1.0f - D.sbar) * pf_fast + D.sbar * pf_slow;
  const float p_ack = D.frac_up_elig * (1.0f - mix);
  const bool ack = up && (u01(seed, node, 2) < p_ack);
  const bool failed = up && !ack;
  if (P.lifeguard)
    lh = min(max(lh + (int)failed - (int)ack, 0), P.awareness_max);

  // target side: truncated-Poisson failed-probe arrivals (k <= 4)
  float base_fail = slow_eff ? D.e_pf_slow : D.e_pf_fast;
  if (FAULT) base_fail = 1.0f - (1.0f - base_fail) * f.suspw;
  float p_fail = up ? base_fail : 1.0f;
  if (BYZ || P.corroboration_k > 0)
    p_fail = p_fail * detection_gate(up, BYZ ? f.forge_ack : 0.0f,
                                     FAULT ? f.mid : 1.0f, P);
  const float eligf = elig ? 1.0f : 0.0f;
  float lam = D.probe_rate * p_fail * eligf;
  if (BYZ) lam = lam + f.spur_susp * eligf;
  const float u_pois = u01(seed, node, 3);
  float term = expf(-lam);
  float cdf = term;
  int n_fail = 0;
#pragma unroll
  for (int k = 1; k <= 4; ++k) {
    n_fail += (u_pois > cdf) ? 1 : 0;
    term = term * lam / (float)k;
    cdf = cdf + term;
  }

  if (status == SUSPECT) sttl -= 1;
  const bool starts = (n_fail > 0) && (status == ALIVE);
  const bool confirms = (n_fail > 0) && (status == SUSPECT);
  const int c0 = max(n_fail - 1, 0);
  // byzantine rounds: a forged suspicion races the full Lifeguard timer
  const float scale =
      (BYZ && P.lifeguard) ? fmaxf(D.scale, 1.0f) : D.scale;
  const float timeout0 = scale * P.susp_max_s * shrink(c0, P, D.log_den);
  const int len0 =
      (int)fminf(ceilf(timeout0 / P.probe_interval), (float)TICK_MAX);
  if (starts) {
    status = SUSPECT;
    slen = len0;
    sttl = len0;
    s_conf = c0;
    informed = P.inv_n;
    new_rumor = true;
  }
  const int c_new = min(s_conf + n_fail, CONF_MAX);
  const float ratio =
      shrink(c_new, P, D.log_den) / shrink(s_conf, P, D.log_den);
  const int len2 = (int)ceilf((float)slen * ratio);
  if (confirms) {
    sttl = sttl - (slen - len2);
    slen = len2;
    s_conf = c_new;
  }

  // refutation race
  float lam_hear = P.fanout_ticks * informed * P.one_minus_loss * g;
  if (FAULT) lam_hear = lam_hear * f.hear_w;
  if (BYZ) lam_hear = lam_hear * (1.0f - f.replay);
  const float p_hear = 1.0f - expf(-lam_hear);
  const bool wrongly =
      up && (status == SUSPECT || status == DEAD) && !new_rumor;
  const bool refute = wrongly && (u01(seed, node, 4) < p_hear);
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
    const float ur = u01(seed, node, 5);
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
  const float lat = (float)(age + 1) * P.probe_interval;

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
  if (FAULT || P.write_age) s.age = up ? (slow ? SLOW_AGE : ALIVE_AGE) : age;
  s.slen = slen;
  s.sttl = sttl;
  s.conf = s_conf;
  s.lh = lh;

  const float upf = up ? 1.0f : 0.0f;
  const bool elig2 = (status == ALIVE) || (status == SUSPECT);
  const float elig2f = elig2 ? 1.0f : 0.0f;
  const float w_fail = upf * (1.0f - p_ack);
  lanes[0] = upf;
  lanes[1] = elig2f;
  lanes[2] = upf * elig2f;
  lanes[3] = (slow && up && elig2) ? 1.0f : 0.0f;
  lanes[4] = upf * pf_fast;
  lanes[5] = upf * pf_slow;
  lanes[6] = w_fail * ((float)lh + 1.0f);
  lanes[7] = w_fail;
  if (P.stats_on) {
    const bool tp = declare && !up;
    lanes[8] += starts ? 1.0f : 0.0f;
    lanes[9] += refute ? 1.0f : 0.0f;
    lanes[10] += (declare && up) ? 1.0f : 0.0f;
    lanes[11] += tp ? 1.0f : 0.0f;
    lanes[12] += tp ? lat : 0.0f;
    lanes[13] += crash ? 1.0f : 0.0f;
    lanes[14] += rejoin ? 1.0f : 0.0f;
    lanes[15] += leave ? 1.0f : 0.0f;
    if (BYZ) {
      lanes[16] += (starts && f.attacked) ? 1.0f : 0.0f;
      lanes[17] += (declare && up && f.attacked) ? 1.0f : 0.0f;
    }
  }
}

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

__device__ __forceinline__ Node load(const Arrays& a, int i) {
  Node s;
  s.status = a.status[i];
  s.inc = a.inc[i];
  s.informed = a.informed[i];
  s.age = a.age[i];
  s.slen = a.slen[i];
  s.sttl = a.sttl[i];
  s.conf = a.conf[i];
  s.lh = a.lh[i];
  return s;
}

__device__ __forceinline__ void store(const Arrays& a, int i, const Node& s,
                                      bool write_age) {
  a.status[i] = (int8_t)s.status;
  a.inc[i] = (int16_t)s.inc;
  a.informed[i] = s.informed;
  if (write_age) a.age[i] = (int16_t)s.age;
  a.slen[i] = (int16_t)s.slen;
  a.sttl[i] = (int16_t)s.sttl;
  a.conf[i] = (int8_t)s.conf;
  a.lh[i] = (int8_t)s.lh;
}

template <bool FAULT, bool BYZ>
__device__ __forceinline__ FaultIn load_fault(const FaultArrays& F, int i) {
  FaultIn f{};
  if (FAULT) {
    f.psend = F.psend[i];
    f.precv = F.precv[i];
    f.suspw = F.suspw[i];
    f.hear_w = F.hear_w[i];
    f.slow_f = F.slow_f[i] != 0;
    f.crash_p = F.crash_p[i];
    f.rejoin_p = F.rejoin_p[i];
    f.leave_p = F.leave_p[i];
    f.mid = *F.mid;
  }
  if (BYZ) {
    f.forge_ack = F.forge_ack[i];
    f.spur_susp = F.spur_susp[i];
    f.replay = F.replay[i];
    f.attacked = F.attacked[i] != 0;
  }
  return f;
}

// Fixed-order block reduction of the lanes into partials[blockIdx.x, :].
__device__ __forceinline__ void block_reduce(float* lanes, int n_lanes,
                                             float* __restrict__ partials) {
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

template <bool FAULT, bool BYZ>
__global__ void __launch_bounds__(THREADS)
    round_kernel(RoundParams P, Arrays a, FaultArrays F,
                 const float* __restrict__ scal,
                 const int32_t* __restrict__ seed,
                 float* __restrict__ partials) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float lanes[N_LANES];
#pragma unroll
  for (int l = 0; l < N_LANES; ++l) lanes[l] = 0.0f;
  if (i < P.rows) {
    const Shared D = derive(scal, P);
    Node s = load(a, i);
    const FaultIn f = load_fault<FAULT, BYZ>(F, i);
    node_round<FAULT, BYZ>(s, P, D, (uint32_t)seed[0], (uint32_t)i, f,
                           lanes);
    store(a, i, s, FAULT || P.write_age);
  }
  block_reduce(lanes, P.stats_on ? N_LANES : N_SCALARS, partials);
}

__global__ void __launch_bounds__(THREADS)
    mega_kernel(RoundParams P, Arrays a, const float* __restrict__ scal,
                const int32_t* __restrict__ seeds, int rounds,
                float* __restrict__ partials) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float lanes[N_LANES];
#pragma unroll
  for (int l = 0; l < N_LANES; ++l) lanes[l] = 0.0f;
  if (i < P.rows) {
    // scalars are frozen for the call, so blocks never wait on each
    // other: each thread carries its node through all rounds in
    // registers, reading it once and writing it once
    const Shared D = derive(scal, P);
    const FaultIn none{};
    Node s = load(a, i);
    for (int r = 0; r < rounds; ++r)
      node_round<false, false>(s, P, D, (uint32_t)seeds[r], (uint32_t)i,
                               none, lanes);
    store(a, i, s, P.write_age);
  }
  // counter lanes hold the call's totals; scalar lanes the last round's
  block_reduce(lanes, P.stats_on ? N_LANES : N_SCALARS, partials);
}

int blocks_for(int rows) { return (rows + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = ok).

int launch_round_kernel(RoundParams P, void* status, void* inc,
                        void* informed, void* age, void* slen, void* sttl,
                        void* conf, void* lh, const void* scal,
                        const void* seed, void* partials, void* stream) {
  Arrays a{(int8_t*)status, (int16_t*)inc,  (float*)informed,
           (int16_t*)age,   (int16_t*)slen, (int16_t*)sttl,
           (int8_t*)conf,   (int8_t*)lh};
  round_kernel<false, false>
      <<<blocks_for(P.rows), THREADS, 0, (cudaStream_t)stream>>>(
          P, a, FaultArrays{}, (const float*)scal, (const int32_t*)seed,
          (float*)partials);
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
  if (byz)
    round_kernel<true, true>
        <<<blocks_for(P.rows), THREADS, 0, (cudaStream_t)stream>>>(
            P, a, F, (const float*)scal, (const int32_t*)seed,
            (float*)partials);
  else
    round_kernel<true, false>
        <<<blocks_for(P.rows), THREADS, 0, (cudaStream_t)stream>>>(
            P, a, F, (const float*)scal, (const int32_t*)seed,
            (float*)partials);
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
  mega_kernel<<<blocks_for(P.rows), THREADS, 0, (cudaStream_t)stream>>>(
      P, a, (const float*)scal, (const int32_t*)seeds, rounds,
      (float*)partials);
  return (int)cudaGetLastError();
}

const char* round_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
