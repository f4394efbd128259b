// The per-lane sample step of the fused kernel: one subsystem solve per
// model subsystem (in chain order), then the output row and state update.
// A line-for-line per-lane rendering of _build.kernel in
// acme_tpu/ops/fused.py (fused.py:1004-2371) for every step configuration
// of the JAX runner: compensated or plain pfull and polish, the fast path
// (fast_iters unguarded steps, or none with polish_only) with its keep
// test at the gate or the polish target and its redo for the lanes that
// fail it ("merge"), for every lane of a lane group with a lane that
// fails it ("group") or for all ("always"), or the robust path every
// sample (fast_iters = 0); extrapolated, "track" or no warm start;
// pivoted or unpivoted main-path solves; the polish loop in plain,
// compensated or df physics; no verdict, or a compensated, df or
// df-residual one with a df elimination on the df-solve subsystems; df or
// plain state.  The header's constants (COMP, DF_STATE, EXTRAP,
// EXTRAP_USE, PIVOT, FAST_ITERS, POLISH_ONLY, VERIFY_ALWAYS, VERIFY_GROUP,
// KEEP_TOL, POL_MODE, VERDICT, RESCUE_MODE, REL_*, and each subsystem's
// DF_SLV and FOLD) pick the configuration at compile time, so each build
// holds only its own branches.
//
// Every loop here is per lane: where the TPU kernel loops until all lanes
// of a group are done (jnp.any / jnp.all exits) and masks the finished
// ones, a thread simply stops.  The TPU loop bodies leave finished lanes
// unchanged (re-evaluating the same point), so the results agree; the
// iteration counters count each lane's own trips.  One decision is the
// group's and not the lane's: the keep test of a VERIFY_GROUP build
// (jax.lax.cond(jnp.all(ok1)), fused.py:2139-2146), where every lane of
// the group meets the others at group_all once per sample and subsystem.
//
// The model-specific parts come from the generated header (emit.py): the
// subsystem traits Sub0, Sub1, ... with their coefficients, EFT dots and
// element physics, plus the output row and the state update.  Coefficients
// that vary between the models of a multi-model runner (fused.py _Var) are
// not literals there but reads of the lane's (hi, lo) table entries, which
// the Lane carries (cv, cvl; NVAR of them) and every generated function
// takes as its first two arguments.
#pragma once

#include "df.cuh"
#include "linsolve.cuh"

#include <chrono>
#include <condition_variable>
#include <mutex>
#include <type_traits>

namespace acme {

using namespace acme_model;

// evaluation modes (fused._Plan): plain, compensated, df physics, the df
// residual with a plain Jacobian (verdict_jac="plain"); NONE: no verdict
enum Mode { NONE = -1, PLAIN = 0, COMPM = 1, DFM = 2, DFRES = 3 };
constexpr bool FAST_PATH = FAST_ITERS > 0 || POLISH_ONLY;

template <int N>
struct cmax1 {
  static constexpr int v = N > 0 ? N : 1;
};

// a lane's lane group, in a VERIFY_GROUP build only (an empty base in
// every other, so their Lane is what it was): on the card the group's
// barrier words (two flag slots, the arrival count, the generation) and
// its warps; on the host the group's HostGroup; and the parity of the
// lane's next barrier, which picks the flag slot
template <bool G>
struct GroupOf {};
template <>
struct GroupOf<true> {
  int* gwords;
  int gwarps;
  void* ghost;
  int gpar;
};

// a block on the card: one warp, a lane a thread (fused.cu)
constexpr int BLOCK = 32;

// the fewest unknowns of a subsystem whose solve is IN_CARRY
constexpr int CARRY_FROM = 6;

// Whether a subsystem's solve is one of CARRY_FROM or more unknowns, whose
// working set leaves no registers on the card for values it reads again
// only after long stretches of work: its pfull pair, p, redo's start and
// kept sensitivity columns then wait in the lane's carry, and compiler
// barriers (carry_fence) keep the values it reads from the carry from
// being held in registers across the solve.  A smaller subsystem keeps
// them in registers, where it reads them fastest.
template <class S>
constexpr bool IN_CARRY = S::NN >= CARRY_FROM;

// the carry's room for what solves IN_CARRY keep there: the largest q
// among them (its pf and pflo hold any one's), and dz/dp's, wp's and z's
// sizes where there is one (none without)
#define ACME_NQ(S) (IN_CARRY<S> ? S::NQ : 0),
constexpr int NQS[] = {ACME_FOR_EACH_SUB(ACME_NQ) 0};
#undef ACME_NQ
constexpr int nq_max() {
  int m = 0;
  for (int v : NQS) m = v > m ? v : m;
  return m;
}
constexpr int NQ_C = nq_max(), NDZ_C = NQ_C > 0 ? NDZ : 0,
              NPT_C = NQ_C > 0 ? NPT : 0, NNT_C = NQ_C > 0 ? NNT : 0;

// The lane's carry across samples: its state (x, z and their lo parts,
// the warm start's zw, wp and dz/dp, the polish-stall flags), its
// tolerances and gates, its per-lane coefficients and input values,
// floats at these offsets, then its iteration counts, ints.  Within a
// sample it also holds what the solve of a subsystem IN_CARRY reads again
// after long stretches of work: its pfull pair (pf, pflo), its p (at wp's
// offsets), the fast path's point (zs, the redo's start, at z's offsets)
// and the sensitivity columns its polish last kept (cols, in dz/dp's
// layout) until they replace its dz/dp.  On the card a block's carry
// lives in shared memory as [value][BLOCK] (value i of thread t at
// i * BLOCK + t: a warp's accesses to one value fall in 32 banks), loaded
// once before the time loop and stored once after it, so the registers
// hold only the working set of the subsystem being solved; on the host a
// lane's carry is one array of its own.
constexpr int C_X = 0, C_XLO = C_X + NX, C_Z = C_XLO + NX, C_ZLO = C_Z + NNT,
              C_ZW = C_ZLO + NNT, C_WP = C_ZW + NNT, C_DZDP = C_WP + NPT,
              C_COLS = C_DZDP + NDZ, C_PF = C_COLS + NDZ_C,
              C_PFLO = C_PF + NQ_C, C_P = C_PFLO + NQ_C, C_ZS = C_P + NPT_C,
              C_PMODE = C_ZS + NNT_C,
              C_TOL = C_PMODE + NSUB,
              C_GATE = C_TOL + NSUB, C_CV = C_GATE + 3 * NSUB,
              C_CVL = C_CV + NVAR, C_LV = C_CVL + NVAR, C_TR = C_LV + NU_L;
constexpr int NCF = cmax1<C_TR>::v, NCI = cmax1<NSUB>::v;

// The lane's tier counters, for a launch handed a stats buffer (fused.cu
// Args::stats; trace.py COUNTERS names the rows in this order): per
// subsystem the clock cycles of each solver tier -- the warm start (p,
// pfull and the extrapolated start), the fast steps, pass 0 of the polish
// with its verdict and fold passes up to the keep test, the redo (the
// robust path and its polish) and the commit (acceptance, the origin
// update; the last subsystem's also the output row and the state update)
// -- and the lane's whole launch (subsystem 0's column; the others hold
// 0); then the counts: subsystem solves, redos (the keep test failed),
// homotopy entries, df rescues, fold passes and the evaluations of the
// fast, polish and redo tiers, which sum to what the solve adds to iters.
// A build without the fast path takes the robust path every sample: its
// full_solve counts as redo and its polish as polish, and no redo is
// counted, as there is no keep test.
enum Stat {
  ST_WARM, ST_FAST, ST_POLISH, ST_REDO, ST_COMMIT, ST_TOTAL, ST_SOLVES,
  ST_REDOS, ST_HOMOTOPY, ST_DF_RESCUES, ST_FOLD_PASSES, ST_EV_FAST,
  ST_EV_POLISH, ST_EV_REDO, NSTAT
};
// the counters' subsystem columns (one without subsystems); counter c of
// subsystem k is the carry's counter c * NS1 + k
constexpr int NS1 = cmax1<NSUB>::v, NCS = NSTAT * NS1;
// What a sample's solves leave for its counters: after the iteration
// counts, per subsystem the clock's readings at its tier boundaries (the
// warm start's end, the fast steps' or the robust path's, the keep test,
// the end of the redo or of the polish, the end of the solve) and its
// ladder's events (a homotopy entry, a df rescue); then the clock at the
// sample's start and end; then the counters, each two ints (its low word
// first), where the loop's other ints are, so that counting takes no
// register of the loop's own.  Floats, at C_TR (TR_*): per subsystem its
// evaluations, the redo's robust path's, its last polish's, and the
// polish passes before each polish's verdict (the first polish's, the
// redo's), from which its fold passes follow.  Only the traced step's
// carry holds them (NCF_TR floats, NCI_TR ints; the untraced step's is
// NCF, NCI).
enum Tick {
  TK_WARM, TK_FAST, TK_KEEP, TK_LOOP, TK_DONE, TK_HOMOTOPY, TK_DF_RESCUE,
  NTK
};
enum Tr { TR_ITV, TR_SV, TR_K, TR_VB0, TR_VB1, NTR };
constexpr int TS_START = NTK * NS1, TS_END = TS_START + 1,
              C_STAT = NS1 + TS_END + 1;
constexpr int NCF_TR = cmax1<C_TR + NTR * NSUB>::v, NCI_TR = C_STAT + 2 * NCS;
#ifdef __CUDA_ARCH__
constexpr int CARRY_STRIDE = BLOCK;
#else
constexpr int CARRY_STRIDE = 1;
#endif

// one run of a lane's carry: its value i at p[i * CARRY_STRIDE]
template <class T>
struct Col {
  T* p;
  HD T& operator[](int i) const { return p[i * CARRY_STRIDE]; }
};

// a lane: views of its carry (f the first float of it, n the first int)
// and its two failure counts
struct Lane : GroupOf<VERIFY_GROUP> {
  Col<float> x, xlo, z, zlo, zw, wp, dzdp, pmode, tol, gate, cv, cvl, lv,
      cols, pf, pflo, p, zs, tr;
  Col<int> iters, tick, stat;
  int fails, floored;
  HD Lane(float* f, int* n)
      : x{f + C_X * CARRY_STRIDE}, xlo{f + C_XLO * CARRY_STRIDE},
        z{f + C_Z * CARRY_STRIDE}, zlo{f + C_ZLO * CARRY_STRIDE},
        zw{f + C_ZW * CARRY_STRIDE}, wp{f + C_WP * CARRY_STRIDE},
        dzdp{f + C_DZDP * CARRY_STRIDE}, pmode{f + C_PMODE * CARRY_STRIDE},
        tol{f + C_TOL * CARRY_STRIDE}, gate{f + C_GATE * CARRY_STRIDE},
        cv{f + C_CV * CARRY_STRIDE}, cvl{f + C_CVL * CARRY_STRIDE},
        lv{f + C_LV * CARRY_STRIDE}, cols{f + C_COLS * CARRY_STRIDE},
        pf{f + C_PF * CARRY_STRIDE}, pflo{f + C_PFLO * CARRY_STRIDE},
        p{f + C_P * CARRY_STRIDE}, zs{f + C_ZS * CARRY_STRIDE},
        tr{f + C_TR * CARRY_STRIDE}, iters{n}, tick{n + NS1 * CARRY_STRIDE},
        stat{n + C_STAT * CARRY_STRIDE}, fails(0), floored(0) {}
};

// -- the tier counters -------------------------------------------------------
//
// The step is compiled twice into each build (the template flag TR): a
// launch without a stats buffer runs the step as it is, with no tracing
// code at all, and a launch with one runs the traced step.  (With the
// marks in the only step, the full path's untraced launches took 6.8 %
// longer over ten chained blocks on the H100, though ptxas reported the
// same registers and no spills.)
// There a solve only leaves marks in the carry: the clock at each tier
// boundary and its ladder's events, each a store, with no branch and
// nothing held in registers.  Every reading sits where the warp's lanes
// have reconverged, so a tier's cycles are the warp's, its wait for
// diverged lanes included.  After each sample the traced launch turns the
// marks into its counters (tier_sample), where the registers are free.

// the SM's cycle counter, its low 32 bits (0 on the host, which counts
// events alone); a tier's cycles within one sample fit them
ACME_FORCEINLINE HD unsigned tier_clock() {
#ifdef __CUDA_ARCH__
  unsigned t;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(t));
  return t;
#else
  return 0;
#endif
}

// all 64 bits of it, for a lane's whole launch
ACME_FORCEINLINE HD long long launch_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}

// (in a traced step) the clock into mark i of subsystem K
template <bool TR, int K>
ACME_FORCEINLINE HD void stamp(const Lane& ln, int i) {
  if constexpr (TR) ln.tick[NTK * K + i] = (int)tier_clock();
}

// counter i
ACME_FORCEINLINE HD long long stat_get(const Lane& ln, int i) {
  return (long long)((unsigned long long)(unsigned)ln.stat[2 * i + 1] << 32 |
                     (unsigned)ln.stat[2 * i]);
}

ACME_FORCEINLINE HD void stat_set(const Lane& ln, int i, long long v) {
  ln.stat[2 * i] = (int)(unsigned)v;
  ln.stat[2 * i + 1] = (int)(unsigned)((unsigned long long)v >> 32);
}

// n more on counter ROW of subsystem K
template <int ROW, int K>
ACME_FORCEINLINE HD void tier_add(const Lane& ln, long long n) {
  stat_set(ln, ROW * NS1 + K, stat_get(ln, ROW * NS1 + K) + n);
}

// the cycles from clock reading a to b
ACME_FORCEINLINE HD long long cycles(int a, int b) {
  return (long long)((unsigned)b - (unsigned)a);
}

// a lane group on the host, whose lanes run on threads of their own: a
// barrier that also ORs the lanes' failures, in the card's two slots
// (`abort`: not every lane's thread started, or a lane waited longer than
// any step takes, `stuck`; the barrier then lets every lane through)
struct HostGroup {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  unsigned gen = 0;
  bool fail[2] = {false, false};
  bool abort = false, stuck = false;
};

// the longest wait at a barrier before the group is taken as stuck (a
// step takes well under a millisecond of one lane's work): on the host
// the run then fails, on the card the kernel traps, rather than hang
constexpr int GROUP_WAIT_SECONDS = 60;
constexpr unsigned long long GROUP_SPINS = 1ull << 27;

// Whether `ok` holds on every lane of this lane's group: every lane of the
// group calls it at the same point of its step (each keep test, once per
// sample and subsystem), and none returns before all have called.
//
// On the card a group spans blocks (32 threads, one warp each; a 2048-lane
// group 64 of them, more than a cluster holds), all resident at once
// (cooperative launch), so it meets at a barrier in device memory:
// __all_sync in the warp, then lane 0 ORs the warp's failure into the flag
// slot of the barrier's parity, arrives, waits for the generation to move,
// reads the slot back and hands it to the warp.  The last warp to arrive
// clears the other slot before it releases the others: every warp read
// that slot after the barrier before and before arriving here, and none
// writes it again until after this barrier.  (A template, so that a build
// without groups never instantiates the group branch.)
template <class LaneT>
ACME_FORCEINLINE HD bool group_all(LaneT& ln, bool ok) {
  if constexpr (!VERIFY_GROUP) {
    return ok;
  } else {
    const int p = ln.gpar;
    ln.gpar = 1 - p;
#ifdef __CUDA_ARCH__
    const bool warp_ok = __all_sync(0xffffffffu, ok);
    int fail = 0;
    if ((threadIdx.x & 31) == 0) {
      int* w = ln.gwords;
      volatile int* vw = w;
      if (!warp_ok) atomicOr(&w[p], 1);
      const int gen = vw[3];
      __threadfence();
      if (atomicAdd(&w[2], 1) == ln.gwarps - 1) {
        atomicExch(&w[2], 0);
        atomicExch(&w[1 - p], 0);
        __threadfence();
        atomicAdd(&w[3], 1);
      } else {
        for (unsigned long long spins = 0; vw[3] == gen;)
          if (++spins > GROUP_SPINS) __trap();
      }
      __threadfence();
      fail = vw[p];
    }
    return __shfl_sync(0xffffffffu, fail, 0) == 0;
#else
    HostGroup& g = *static_cast<HostGroup*>(ln.ghost);
    std::unique_lock<std::mutex> lock(g.m);
    if (!ok) g.fail[p] = true;
    const unsigned gen = g.gen;
    if (++g.count == g.n) {
      g.count = 0;
      g.fail[1 - p] = false;
      ++g.gen;
      g.cv.notify_all();
    } else {
      if (!g.cv.wait_for(lock, std::chrono::seconds(GROUP_WAIT_SECONDS),
                          [&] { return g.abort || g.gen != gen; })) {
        g.abort = g.stuck = true;
        g.cv.notify_all();
      }
    }
    return !g.fail[p];
#endif
  }
}

// the sample's view of one subsystem: its p, pfull pair (views of the
// carry's in a solve IN_CARRY) and tolerances
template <class S>
struct Ctx {
  static constexpr int NN = S::NN, NQ = S::NQ, NP = cmax1<S::NP>::v;
  using Pf = std::conditional_t<IN_CARRY<S>, Col<float>, float[NQ]>;
  float p[NP];
  Pf pf, pflo;
  float ltol, lgate, gate_v, ptol;
  const Lane* ln;
};

// In a solve IN_CARRY, a compiler barrier: what the solve read from the
// carry before it, or wrote there, it reads from the carry again after it.
template <class S>
ACME_FORCEINLINE HD void carry_fence() {
#ifdef __CUDA_ARCH__
  if constexpr (IN_CARRY<S>) asm volatile("" ::: "memory");
#endif
}

// the subsystem's p, i
template <class S>
ACME_FORCEINLINE HD float p_at(const Ctx<S>& cx, int i) {
  if constexpr (IN_CARRY<S>)
    return cx.ln->p[S::POFF + i];
  else
    return cx.p[i];
}

template <class S>
struct Eval {
  float res[S::NN];
  float J[S::NN][S::NN];
  float Jq[S::NN * S::NQ];
  float q[S::NQ];
  float resmax, scale;
};

// the df Newton system of a df-solve subsystem's df evaluation
template <class S>
struct DfSys {
  df res[S::NN];
  df J[S::NN][S::NN];
};

template <class S>
ACME_FORCEINLINE HD void eval_stats(Eval<S>& e) {
  float rm = fabsf(e.res[0]);
  ACME_UNROLL
  for (int a = 1; a < S::NN; ++a) rm = jmax(rm, fabsf(e.res[a]));
  e.resmax = rm;
  float sc = 0.0f;
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) {
    float acc = fabsf(e.Jq[a * S::NQ]) * fabsf(e.q[0]);
    ACME_UNROLL
    for (int c = 1; c < S::NQ; ++c)
      acc = acc + fabsf(e.Jq[a * S::NQ + c]) * fabsf(e.q[c]);
    sc = a == 0 ? acc : jmax(sc, acc);
  }
  e.scale = sc;
}

// eval_at in plain mode: q = pfull + Fq z (or pf + Fq z for the homotopy)
template <class S, class P>
ACME_FORCEINLINE HD void eval_plain(const Ctx<S>& cx, P pf,
                                    const float (&z)[S::NN], Eval<S>& e,
                                    bool stats) {
  const Lane& ln = *cx.ln;
  S::q_plain(ln.cv, ln.cvl, z, pf, e.q);
  S::nl(e.q, e.res, e.Jq);
  S::jac(ln.cv, ln.cvl, e.Jq, &e.J[0][0]);
  if (stats) eval_stats<S>(e);
}

// eval_at in compensated mode: q as an EFT pair, res += Jq q_lo
template <class S>
ACME_FORCEINLINE HD void eval_comp(const Ctx<S>& cx, const float (&z)[S::NN],
                                   Eval<S>& e) {
  const Lane& ln = *cx.ln;
  float qlo[S::NQ];
  S::q_comp(ln.cv, ln.cvl, z, cx.pf, cx.pflo, e.q, qlo);
  S::nl(e.q, e.res, e.Jq);
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) {
    float acc = e.res[a];
    ACME_UNROLL
    for (int c = 0; c < S::NQ; ++c) acc = acc + e.Jq[a * S::NQ + c] * qlo[c];
    e.res[a] = acc;
  }
  S::jac(ln.cv, ln.cvl, e.Jq, &e.J[0][0]);
  eval_stats<S>(e);
}

// eval_at in df mode: element physics on (hi, lo) pairs, collapsed; with
// SYS also the df Newton system for the df elimination
template <class S, bool SYS>
ACME_FORCEINLINE HD void eval_df(const Ctx<S>& cx, const float (&z)[S::NN],
                                 Eval<S>& e, DfSys<S>& sys) {
  const Lane& ln = *cx.ln;
  float qlo[S::NQ];
  S::q_comp(ln.cv, ln.cvl, z, cx.pf, cx.pflo, e.q, qlo);
  df qd[S::NQ], rd[S::NN], Jqd[S::NN * S::NQ];
  ACME_UNROLL
  for (int c = 0; c < S::NQ; ++c) qd[c] = df(e.q[c], qlo[c]);
  S::nl_df(qd, rd, Jqd);
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) e.res[a] = rd[a].hi + rd[a].lo;
  ACME_UNROLL
  for (int i = 0; i < S::NN * S::NQ; ++i) e.Jq[i] = Jqd[i].hi + Jqd[i].lo;
  S::jac(ln.cv, ln.cvl, e.Jq, &e.J[0][0]);
  if constexpr (SYS) {
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) sys.res[a] = rd[a];
    S::jac_df(ln.cv, ln.cvl, Jqd, &sys.J[0][0]);
  }
  eval_stats<S>(e);
}

// eval_at with the df residual and the plain Jacobian of the same point
// (fused.py:1240-1254): each half computes only the nodes it needs; only a
// build with that verdict has them (emit.py)
template <class S>
ACME_FORCEINLINE HD void eval_dfres(const Ctx<S>& cx,
                                    const float (&z)[S::NN], Eval<S>& e) {
  if constexpr (VERDICT == DFRES) {
    const Lane& ln = *cx.ln;
    float qlo[S::NQ];
    S::q_comp(ln.cv, ln.cvl, z, cx.pf, cx.pflo, e.q, qlo);
    df qd[S::NQ], rd[S::NN];
    ACME_UNROLL
    for (int c = 0; c < S::NQ; ++c) qd[c] = df(e.q[c], qlo[c]);
    S::nl_df_res(qd, rd);
    S::nl_jq(e.q, e.Jq);
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) e.res[a] = rd[a].hi + rd[a].lo;
    S::jac(ln.cv, ln.cvl, e.Jq, &e.J[0][0]);
    eval_stats<S>(e);
  }
}

// eval_at in MODE, with the df Newton system when SYS (df mode)
template <class S, int MODE, bool SYS>
ACME_FORCEINLINE HD void eval_mode(const Ctx<S>& cx, const float (&z)[S::NN],
                                   Eval<S>& e, DfSys<S>& sys) {
  if constexpr (MODE == DFM)
    eval_df<S, SYS>(cx, z, e, sys);
  else if constexpr (MODE == DFRES)
    eval_dfres<S>(cx, z, e);
  else if constexpr (MODE == COMPM)
    eval_comp<S>(cx, z, e);
  else
    eval_plain<S>(cx, cx.pf, z, e, true);
}

template <class S>
ACME_FORCEINLINE HD float clipz(float d, int i) {
  return jclip(d, -S::zclip(i), S::zclip(i));
}

template <class S>
ACME_FORCEINLINE HD bool all_finite(const float (&v)[S::NN]) {
  bool ok = true;
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) ok = ok && jfinite(v[a]);
  return ok;
}

// -- the robust path: gated Newton, homotopy, df Newton ----------------------

template <class S>
struct Solved {
  float z[S::NN];
  float r, g, itv;
};

// gated Newton loop (fused.py:1373-1483)
template <class S>
ACME_FORCEINLINE HD void run_newton(const Ctx<S>& cx,
                                    const float (&zs)[S::NN],
                                    Solved<S>& out) {
  float z[S::NN];
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) z[a] = zs[a], out.z[a] = zs[a];
  float prev = 3e38f, strikes = 0.0f, strikes_hi = 0.0f;
  out.r = 3e38f;
  out.g = cx.lgate;
  out.itv = (float)K_NEWTON;
  ACME_ROLLED
  for (int it = 0; it < K_NEWTON; ++it) {
    Eval<S> e;
    eval_plain<S>(cx, cx.pf, z, e, true);
    float tol_eff = jclip(REL_TOL * e.scale, cx.ltol, 1e4f * cx.ltol);
    float gate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
    float R[1][S::NN], X[1][S::NN];
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
    solve_rows<S::NN, 1, float>(e.J, R, X, 0, PIVOT);
    bool stall_any = e.resmax >= 0.995f * prev;
    bool stalled = stall_any && (e.resmax < gate_eff);
    strikes = stalled ? strikes + 1.0f : 0.0f;
    strikes_hi = (stall_any && (e.resmax >= gate_eff)) ? strikes_hi + 1.0f
                                                       : 0.0f;
    bool struck = strikes >= STALL_STRIKES;
    bool plat = strikes_hi >= PLATEAU_STRIKES;
    bool done = (e.resmax < tol_eff) || struck || plat;
    bool bad = !jfinite(e.resmax) || !all_finite<S>(X[0]);
    bool move = !(done || bad);
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) out.z[a] = z[a];
    out.r = e.resmax;
    out.g = gate_eff;
    if (done) {
      out.itv = (float)(it + 1);
      break;
    }
    if (move) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) z[a] = z[a] - clipz<S>(X[0][a], a);
    }
    prev = e.resmax;
  }
}

// bisection homotopy continuation from (wp, zw) (fused.py:1485-1583)
template <class S>
ACME_FORCEINLINE HD void homotopy_rescue(const Ctx<S>& cx, Solved<S>& st) {
  constexpr int K2 = 16, TRIPS = 6 * 16;
  const Lane& ln = *cx.ln;
  float z_h[S::NN], z_good[S::NN];
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) {
    z_h[a] = st.z[a];
    z_good[a] = ln.zw[S::OFF + a];
  }
  float a_good = 0.0f, a_try = 1.0f, k_in = 0.0f;
  bool solved = false;
  int trips = 0;
  ACME_ROLLED
  while (trips < TRIPS && !solved) {
    float pmix[Ctx<S>::NP], pf[S::NQ];
    ACME_UNROLL
    for (int i = 0; i < S::NP; ++i)
      pmix[i] = ln.wp[S::POFF + i] +
                a_try * (p_at<S>(cx, i) - ln.wp[S::POFF + i]);
    S::pf_mix(ln.cv, ln.cvl, pmix, pf);
    Eval<S> e;
    eval_plain<S>(cx, pf, z_h, e, true);
    float gate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
    bool ok = e.resmax < gate_eff;
    float R[1][S::NN], X[1][S::NN];
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
    solve_rows<S::NN, 1, float>(e.J, R, X, 0, true);
    bool bad = !jfinite(e.resmax) || !all_finite<S>(X[0]);
    bool move = !(ok || bad);
    float z_new[S::NN];
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a)
      z_new[a] = move ? z_h[a] - clipz<S>(X[0][a], a) : z_h[a];
    if (ok) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) z_good[a] = z_h[a];
      a_good = a_try;
      if (a_try >= 1.0f) solved = true;
    }
    float k_next = ok ? 0.0f : k_in + 1.0f;
    bool exh = (k_next >= (float)K2) && !ok;
    float a_next = ok ? 1.0f : (exh ? 0.5f * (a_good + a_try) : a_try);
    if (exh) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) z_new[a] = z_good[a];
      k_next = 0.0f;
    }
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) z_h[a] = z_new[a];
    a_try = a_next;
    k_in = k_next;
    ++trips;
  }
  if (solved) {
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) st.z[a] = z_h[a];
    st.r = 0.5f * st.g;
  }
  st.itv = st.itv + (float)trips;
}

// double-float-residual Newton rescue (fused.py:1585-1637), in df physics
// whenever the runner has df_polish, else in the polish loop's mode
template <class S>
ACME_FORCEINLINE HD void df_rescue(const Ctx<S>& cx, Solved<S>& st) {
  constexpr int K3 = 24;
  float zs[S::NN];
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) zs[a] = st.z[a];
  float rm = 3e38f;
  int k = 0;
  ACME_ROLLED
  while (k < K3 && !(rm < st.g)) {
    Eval<S> e;
    DfSys<S> unused;
    eval_mode<S, RESCUE_MODE, false>(cx, zs, e, unused);
    bool ok = e.resmax < st.g;
    float R[1][S::NN], X[1][S::NN];
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
    solve_rows<S::NN, 1, float>(e.J, R, X, REFINE, true);
    bool bad = !jfinite(e.resmax) || !all_finite<S>(X[0]);
    if (!(ok || bad)) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) zs[a] = zs[a] - clipz<S>(X[0][a], a);
    }
    rm = e.resmax;
    ++k;
  }
  if ((rm < st.r) || !jfinite(st.r)) {
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) st.z[a] = zs[a];
    st.r = rm;
  }
  st.itv = st.itv + (float)k;
}

template <class S, bool TR>
ACME_FORCEINLINE HD void full_solve(const Ctx<S>& cx,
                                    const float (&zs)[S::NN], Solved<S>& st) {
  run_newton<S>(cx, zs, st);
  if (!(st.r < st.g)) {
    if constexpr (TR) cx.ln->tick[NTK * S::IDX + TK_HOMOTOPY] = 1;
    homotopy_rescue<S>(cx, st);
  }
  if (!(st.r < st.g)) {
    if constexpr (TR) cx.ln->tick[NTK * S::IDX + TK_DF_RESCUE] = 1;
    df_rescue<S>(cx, st);
  }
}

// -- the polish and the verdict ----------------------------------------------

template <class S>
struct PolishEval {
  float dz[S::NN];
  float cols[Ctx<S>::NP][S::NN];
  float resmax, lgate_eff, gate_eff_f, tol_pol, ltol_eff;
  bool fin;
};

// the shared elimination X = J \ [res | Jp] of polish_eval: M = 1 + the
// sensitivity columns, in df (DFSYS) for the fragile subsystems' df
// verdict
template <class S, int M, bool DFSYS>
ACME_FORCEINLINE HD void polish_solve(const Eval<S>& e, const DfSys<S>& sys,
                                      const float* jp, int rf,
                                      float (&X)[M][S::NN]) {
  float R[M][S::NN];
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
  ACME_UNROLL
  for (int b = 0; b + 1 < M; ++b) {
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) R[1 + b][a] = jp[b * S::NN + a];
  }
  if constexpr (DFSYS) {
    df Rd[M][S::NN];
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) Rd[0][a] = sys.res[a];
    ACME_UNROLL
    for (int b = 1; b < M; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) Rd[b][a] = df(R[b][a]);
    }
    // each column collapsed as the elimination finishes it
    solve_rows<S::NN, M, df>(sys.J, Rd, X, 0, true);
  } else {
    solve_rows<S::NN, M, float>(e.J, R, X, rf, true);
  }
}

// whether a polish_eval in that mode solves for the sensitivity columns
template <class S, bool LIGHT>
constexpr bool HAS_COLS = EXTRAP && S::NP > 0 && !LIGHT;

// one evaluation in MODE + shared elimination X = J \ [res | Jp]
// (fused.py:1652); LIGHT drops the columns and the refinement, VERD
// refines as the verdict does
template <class S, int MODE, bool LIGHT, bool VERD>
ACME_FORCEINLINE HD void polish_eval(const Ctx<S>& cx,
                                     const float (&z)[S::NN],
                                     PolishEval<S>& pe) {
  constexpr int NP = Ctx<S>::NP;
  // a df-solve subsystem's df evaluation also builds the df system
  constexpr bool DFSYS = S::DF_SLV && MODE == DFM;
  Eval<S> e;
  DfSys<S> sys;
  eval_mode<S, MODE, DFSYS>(cx, z, e, sys);
  pe.lgate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
  pe.gate_eff_f = jclip(REL_GATE_F * e.scale, cx.gate_v, 1e4f * cx.gate_v);
  pe.tol_pol = jclip(REL_TOL_POL * e.scale, cx.ptol, 1e4f * cx.ptol);
  pe.ltol_eff = jclip(REL_TOL * e.scale, cx.ltol, 1e4f * cx.ltol);
  pe.resmax = e.resmax;
  const int rf = LIGHT ? 0 : (VERD ? VREFINE : REFINE);
  // the sensitivity columns ride along while the origin is maintained
  if constexpr (HAS_COLS<S, LIGHT>) {
    float jp[NP * S::NN], X[1 + NP][S::NN];
    S::jp(cx.ln->cv, cx.ln->cvl, e.Jq, jp);
    polish_solve<S, 1 + NP, DFSYS>(e, sys, jp, rf, X);
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) pe.dz[a] = X[0][a];
    ACME_UNROLL
    for (int b = 0; b < NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) pe.cols[b][a] = X[1 + b][a];
    }
  } else {
    float X[1][S::NN];
    polish_solve<S, 1, DFSYS>(e, sys, nullptr, rf, X);
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a) pe.dz[a] = X[0][a];
    // NaN placeholder columns: a non-finite verdict then keeps the old
    // sensitivity (the |cols| < 1e6 install bound rejects NaN)
    ACME_UNROLL
    for (int b = 0; b < NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) pe.cols[b][a] = NAN;
    }
  }
  pe.fin = jfinite(e.resmax) && all_finite<S>(pe.dz);
}

// the polish's state; its sensitivity columns in registers, or in a
// solve IN_CARRY where `cols` says: zeros (0), a pass's NaN placeholders
// (1) or the carry's cols (2)
template <class S>
struct PolishSt {
  float z[S::NN], zlo[S::NN];
  std::conditional_t<IN_CARRY<S>, int, float[Ctx<S>::NP][S::NN]> cols;
  float rm, rm1, tl1, lg, gf, tp, pfrz, pstall, k;
};

// the polish state's sensitivity columns set to zeros
template <class S>
ACME_FORCEINLINE HD void zero_cols(PolishSt<S>& st) {
  if constexpr (IN_CARRY<S>) {
    st.cols = 0;
  } else {
    ACME_UNROLL
    for (int b = 0; b < Ctx<S>::NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) st.cols[b][a] = 0.0f;
    }
  }
}

// a pass's sensitivity columns kept in the polish state (in a solve
// IN_CARRY real ones go to the carry's cols, in dz/dp's layout)
template <class S, bool LIGHT>
ACME_FORCEINLINE HD void keep_cols(const Ctx<S>& cx, const PolishEval<S>& pe,
                                   PolishSt<S>& st) {
  if constexpr (!IN_CARRY<S>) {
    ACME_UNROLL
    for (int b = 0; b < Ctx<S>::NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) st.cols[b][a] = pe.cols[b][a];
    }
  } else if constexpr (HAS_COLS<S, LIGHT>) {
    ACME_UNROLL
    for (int b = 0; b < S::NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a)
        cx.ln->cols[S::DOFF + a * S::NP + b] = pe.cols[b][a];
    }
    st.cols = 2;
  } else {
    st.cols = 1;
  }
}

// the polish state's sensitivity column b, element a
template <class S>
ACME_FORCEINLINE HD float col_at(const Ctx<S>& cx, const PolishSt<S>& st,
                                 int b, int a) {
  if constexpr (IN_CARRY<S>)
    return st.cols == 2 ? cx.ln->cols[S::DOFF + a * S::NP + b]
                        : (st.cols == 1 ? NAN : 0.0f);
  else
    return st.cols[b][a];
}

// a verdict pass's results (fused.py:1898-1948), for a pass that is kept
template <class S>
ACME_FORCEINLINE HD void vd_keep(const Ctx<S>& cx, const PolishEval<S>& pe,
                                 PolishSt<S>& st) {
  if (pe.fin) st.tp = pe.tol_pol;
  bool vstep = S::DF_SLV ? pe.fin : (pe.fin && pe.resmax >= pe.tol_pol);
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) {
    float dzc = clipz<S>(pe.dz[a], a);
    float hi2, lo2;
    two_sum(st.z[a], -dzc, hi2, lo2);
    st.z[a] = vstep ? hi2 : st.z[a];
    st.zlo[a] = vstep ? lo2 : 0.0f;
  }
  if (pe.fin) {
    st.rm = pe.resmax;
    st.lg = pe.lgate_eff;
    st.gf = pe.gate_eff_f;
    keep_cols<S, false>(cx, pe, st);
  }
}

// the polish loop (plain, compensated or df) with its unrolled prefix,
// then the verdict, if any, and the fold continuation (fused.py:1750-2016)
template <class S, bool TR>
ACME_FORCEINLINE HD void polish_all(const Ctx<S>& cx,
                                    const float (&zs)[S::NN], PolishSt<S>& st,
                                    int pass = 0) {
  ACME_UNROLL
  for (int a = 0; a < S::NN; ++a) st.z[a] = zs[a], st.zlo[a] = 0.0f;
  zero_cols<S>(st);
  st.rm = 3e38f;
  st.rm1 = 3e38f;
  st.tl1 = cx.ltol;
  st.lg = cx.lgate;
  st.gf = cx.gate_v;
  st.tp = cx.ptol;
  st.pfrz = 0.0f;
  st.pstall = 0.0f;
  st.k = 0.0f;
  const int nfix = P_FIX < P_POL ? P_FIX : P_POL;
  ACME_ROLLED
  for (int it = 0;; ++it) {
    if (it >= nfix &&
        !(st.k < (float)P_POL && !((st.rm < st.tp) || (st.pfrz > 0.5f))))
      break;
    PolishEval<S> pe;
    // with a verdict the loop's steps drop the columns and refinement
    polish_eval<S, POL_MODE, VERDICT != NONE, false>(cx, st.z, pe);
    bool nc = pe.fin && (pe.resmax >= 0.7f * st.rm);
    if (nc) st.pfrz = 1.0f;
    bool unclip = true;
    ACME_UNROLL
    for (int a = 0; a < S::NN; ++a)
      unclip = unclip && (fabsf(pe.dz[a]) < 0.9f * S::zclip(a));
    if (nc && unclip && (pe.resmax >= pe.tol_pol) &&
        (pe.resmax < 1e3f * pe.gate_eff_f))
      st.pstall = 1.0f;
    bool first = st.k == 0.0f;
    bool act = pe.fin && (pe.resmax >= pe.tol_pol) && (first || st.pfrz < 0.5f);
    if (act) {
      ACME_UNROLL
      for (int a = 0; a < S::NN; ++a) st.z[a] = st.z[a] - clipz<S>(pe.dz[a], a);
    }
    if (first) {
      st.rm1 = pe.resmax;
      st.tl1 = pe.ltol_eff;
    }
    st.rm = pe.resmax;
    st.lg = pe.lgate_eff;
    st.gf = pe.gate_eff_f;
    st.tp = pe.tol_pol;
    keep_cols<S, VERDICT != NONE>(cx, pe, st);
    st.k = st.k + 1.0f;
  }
  if constexpr (VERDICT != NONE) {
    // the verdict pass, then with FOLD up to nine fold passes while the
    // residual stays above VTGT, each kept where it takes the residual
    // down by a tenth: one pass in the code
    float rm_prev = 0.0f;
    // the passes so far (pass: 0 the first polish, 1 the redo's): the
    // fold passes are the verdict's, each counted in st.k, but its first.
    // A store here and nothing in the loop: on the H100, counting inside
    // it made the traced step spill (2.4 times the time), and adding to a
    // counter around it cost 6-7 %.
    if constexpr (TR && S::FOLD)
      cx.ln->tr[NTR * S::IDX + TR_VB0 + pass] = st.k;
    ACME_ROLLED
    for (int i = 0; i <= (S::FOLD ? 9 : 0); ++i) {
      if (i > 0 && !((rm_prev >= VTGT) && jfinite(rm_prev))) break;
      PolishEval<S> pe;
      polish_eval<S, S::DF_SLV ? (int)DFM : VERDICT, false, true>(cx, st.z,
                                                                  pe);
      bool act = i == 0 || pe.resmax <= 0.9f * rm_prev;
      rm_prev = act ? pe.resmax : 0.0f;
      if (act) vd_keep<S>(cx, pe, st);
      st.k = st.k + 1.0f;
    }
  }
}

// -- one subsystem's per-sample solve (fused.py:1072-2266) --------------------

// its p from x, u and the sample's z so far (the carry's z, which holds
// the earlier subsystems' solutions of this sample), its solve, and its
// part of z, the warm start and the counters written back to the carry
template <class S, bool TR>
ACME_FORCEINLINE HD void solve_sub(Lane& ln, const float* u, bool& any_fail,
                                   bool& any_floor) {
  constexpr int NN = S::NN, NP = Ctx<S>::NP;
  Ctx<S> cx;
  cx.ln = &ln;
  cx.ltol = ln.tol[S::IDX];
  cx.lgate = ln.gate[S::IDX];
  cx.gate_v = ln.gate[NSUB + S::IDX];
  cx.ptol = ln.gate[2 * NSUB + S::IDX];
  if constexpr (DF_STATE)
    S::p_of(ln.cv, ln.cvl, ln.x, ln.xlo, u, ln.z, ln.zlo, cx.p);
  else
    S::p_plain(ln.cv, ln.cvl, ln.x, u, ln.z, cx.p);
  if constexpr (IN_CARRY<S>) {
    ACME_UNROLL
    for (int i = 0; i < S::NP; ++i) ln.p[S::POFF + i] = cx.p[i];
    cx.pf = ln.pf;
    cx.pflo = ln.pflo;
  }
  if constexpr (COMP) {
    S::pfull(ln.cv, ln.cvl, cx.p, cx.pf, cx.pflo);
  } else {
    S::pf_mix(ln.cv, ln.cvl, cx.p, cx.pf);
    ACME_UNROLL
    for (int c = 0; c < S::NQ; ++c) cx.pflo[c] = 0.0f;
  }
  // extrapolated warm start, jump capped at 4 trust regions (with
  // extrapolate "track" or False the start is zw itself)
  float z0[NN];
  ACME_UNROLL
  for (int i1 = 0; i1 < NN; ++i1) {
    if constexpr (EXTRAP_USE && S::NP > 0) {
      float acc = 0.0f;
      ACME_UNROLL
      for (int i2 = 0; i2 < S::NP; ++i2) {
        float term = ln.dzdp[S::DOFF + i1 * S::NP + i2] *
                     (cx.p[i2] - ln.wp[S::POFF + i2]);
        acc = i2 == 0 ? term : acc + term;
      }
      z0[i1] = ln.zw[S::OFF + i1] +
               jclip(acc, -4.0f * S::zclip(i1), 4.0f * S::zclip(i1));
    } else {
      z0[i1] = ln.zw[S::OFF + i1];
    }
  }
  carry_fence<S>();
  stamp<TR, S::IDX>(ln, TK_WARM);
  PolishSt<S> st;
  float itv;
  if constexpr (!FAST_PATH) {
    // the robust path from the start, then the polish (fused.py:2147-2151)
    Solved<S> sv;
    full_solve<S, TR>(cx, z0, sv);
    stamp<TR, S::IDX>(ln, TK_FAST);
    polish_all<S, TR>(cx, sv.z, st);
    stamp<TR, S::IDX>(ln, TK_LOOP);
    itv = sv.itv + st.k;
    if constexpr (TR) {
      ln.tr[NTR * S::IDX + TR_ITV] = itv;
      ln.tr[NTR * S::IDX + TR_K] = st.k;
    }
  } else {
    // unguarded fast path with the already-converged guard (no step with
    // polish_only)
    float zs[NN];
    ACME_UNROLL
    for (int a = 0; a < NN; ++a) zs[a] = z0[a];
    ACME_ROLLED
    for (int f = 0; f < FAST_ITERS; ++f) {
      Eval<S> e;
      eval_plain<S>(cx, cx.pf, zs, e, false);
      float rmf = fabsf(e.res[0]);
      ACME_UNROLL
      for (int a = 1; a < NN; ++a) rmf = jmax(rmf, fabsf(e.res[a]));
      float R[1][NN], X[1][NN];
      ACME_UNROLL
      for (int a = 0; a < NN; ++a) R[0][a] = e.res[a];
      solve_rows<NN, 1, float>(e.J, R, X, 0, PIVOT);
      bool okf = all_finite<S>(X[0]) && (rmf >= cx.ltol);
      if (okf) {
        ACME_UNROLL
        for (int a = 0; a < NN; ++a) zs[a] = zs[a] - clipz<S>(X[0][a], a);
      }
    }
    // the polish from the fast path's point, and for a lane that fails
    // the keep test ("merge"), every lane of a group with a lane that
    // fails it ("group") or every lane ("always") the redo: the robust
    // path from the same start, then the polish again (one polish in the
    // code)
    float zp[NN], sv_itv = 0.0f;
    ACME_UNROLL
    for (int a = 0; a < NN; ++a) zp[a] = zs[a];
    if constexpr (IN_CARRY<S>) {
      // the redo's start waits in the carry
      ACME_UNROLL
      for (int a = 0; a < NN; ++a) ln.zs[S::OFF + a] = zs[a];
      carry_fence<S>();
    }
    stamp<TR, S::IDX>(ln, TK_FAST);
    ACME_ROLLED
    for (int pass = 0; pass < 2; ++pass) {
      polish_all<S, TR>(cx, zp, st, pass);
      if (pass == 0) {
        itv = (float)FAST_ITERS + st.k;
        const float keep_thr = KEEP_TOL ? st.tp : st.gf;
        bool ok1 =
            (st.rm < keep_thr) || ((st.rm1 < st.tl1) && (st.pstall > 0.5f));
        stamp<TR, S::IDX>(ln, TK_KEEP);
        if (!(VERIFY_ALWAYS || (VERIFY_GROUP ? !group_all(ln, ok1) : !ok1)))
          break;
        Solved<S> sv;
        if constexpr (IN_CARRY<S>) {
          ACME_UNROLL
          for (int a = 0; a < NN; ++a) zs[a] = ln.zs[S::OFF + a];
        }
        full_solve<S, TR>(cx, zs, sv);
        ACME_UNROLL
        for (int a = 0; a < NN; ++a) zp[a] = sv.z[a];
        sv_itv = sv.itv;
      } else {
        itv = itv + (sv_itv + st.k);
      }
    }
    stamp<TR, S::IDX>(ln, TK_LOOP);
    if constexpr (TR) {
      ln.tr[NTR * S::IDX + TR_ITV] = itv;
      ln.tr[NTR * S::IDX + TR_SV] = sv_itv;
      ln.tr[NTR * S::IDX + TR_K] = st.k;
    }
  }
  carry_fence<S>();
  // acceptance, floor certificate, plausibility substitution
  bool z_implaus = false;
  ACME_UNROLL
  for (int a = 0; a < NN; ++a)
    z_implaus = z_implaus || !jfinite(st.z[a]) || (fabsf(st.z[a]) > 1e4f);
  bool conv = (st.rm < st.gf) || ((st.pstall > 0.5f) && !z_implaus);
  bool fail_k = !conv;
  bool implaus = z_implaus || !jfinite(st.rm);
  bool floor_k = conv && !(st.rm < st.gf);
  any_fail = any_fail || fail_k;
  any_floor = any_floor || floor_k;
  ln.pmode[S::IDX] = st.pstall;
  ln.iters[S::IDX] += (int)itv;
  bool zsub = fail_k && implaus;
  ACME_UNROLL
  for (int a = 0; a < NN; ++a) {
    ln.z[S::OFF + a] = zsub ? ln.zw[S::OFF + a] : st.z[a];
    ln.zlo[S::OFF + a] = zsub ? 0.0f : st.zlo[a];
  }
  bool ok = !implaus;
  if constexpr (EXTRAP && S::NP > 0) {
    bool okd = ok && conv;
    ACME_UNROLL
    for (int b = 0; b < S::NP; ++b) {
      ACME_UNROLL
      for (int a = 0; a < NN; ++a)
        okd = okd && (fabsf(col_at<S>(cx, st, b, a)) < 1e6f);
    }
    if (ok) {
      ACME_UNROLL
      for (int a = 0; a < NN; ++a) ln.zw[S::OFF + a] = st.z[a];
      ACME_UNROLL
      for (int i = 0; i < S::NP; ++i) ln.wp[S::POFF + i] = p_at<S>(cx, i);
    }
    if (okd) {
      ACME_UNROLL
      for (int a = 0; a < NN; ++a) {
        ACME_UNROLL
        for (int i = 0; i < S::NP; ++i)
          ln.dzdp[S::DOFF + a * S::NP + i] = -col_at<S>(cx, st, i, a);
      }
    }
  } else if (ok) {
    // the position origin follows even without extrapolation
    ACME_UNROLL
    for (int a = 0; a < NN; ++a) ln.zw[S::OFF + a] = st.z[a];
    ACME_UNROLL
    for (int i = 0; i < S::NP; ++i) ln.wp[S::POFF + i] = p_at<S>(cx, i);
  }
  carry_fence<S>();
  stamp<TR, S::IDX>(ln, TK_DONE);
}

// one sample: subsystems in chain order (each writes its part of the
// carry's z in place), then output row and state update
template <bool TR>
ACME_FORCEINLINE HD void sample(Lane& ln, const float* u_t, float* y) {
  if constexpr (TR) ln.tick[TS_START] = (int)tier_clock();
  float u[cmax1<NU>::v];
  u_full(u_t, ln.lv, u);
  bool any_fail = false, any_floor = false;
#define ACME_SOLVE(S) solve_sub<S, TR>(ln, u, any_fail, any_floor);
  ACME_FOR_EACH_SUB(ACME_SOLVE)
#undef ACME_SOLVE
  float xn[cmax1<NX>::v], xnlo[cmax1<NX>::v];
  if constexpr (DF_STATE) {
    output_row(ln.cv, ln.cvl, ln.x, ln.xlo, u, ln.z, ln.zlo, y);
    state_update(ln.cv, ln.cvl, ln.x, ln.xlo, u, ln.z, ln.zlo, xn, xnlo);
  } else {
    // plain read-outs; state and z without lo parts
    output_plain(ln.cv, ln.cvl, ln.x, u, ln.z, y);
    state_plain(ln.cv, ln.cvl, ln.x, u, ln.z, xn);
    ACME_UNROLL
    for (int i = 0; i < NX; ++i) xnlo[i] = 0.0f;
    ACME_UNROLL
    for (int i = 0; i < NNT; ++i) ln.zlo[i] = 0.0f;
  }
  ACME_UNROLL
  for (int i = 0; i < NX; ++i) ln.x[i] = xn[i], ln.xlo[i] = xnlo[i];
  if (NSUB > 0) {
    ln.fails += any_fail ? 1 : 0;
    ln.floored += any_floor ? 1 : 0;
  }
  if constexpr (TR) ln.tick[TS_END] = (int)tier_clock();
}

// one subsystem's part of a sample's counters, from its marks; prev: the
// clock where its warm start began; returns the clock at its end
template <class S>
ACME_FORCEINLINE HD int tier_sub(const Lane& ln, int prev) {
  constexpr int K = S::IDX, T = NTK * K, R = NTR * K;
  constexpr bool FOLDS = S::FOLD && VERDICT != NONE;
  const int warm = ln.tick[T + TK_WARM], fast = ln.tick[T + TK_FAST],
            keep = ln.tick[T + TK_KEEP], loop = ln.tick[T + TK_LOOP],
            done = ln.tick[T + TK_DONE];
  tier_add<ST_WARM, K>(ln, cycles(prev, warm));
  const float itv = ln.tr[R + TR_ITV], k = ln.tr[R + TR_K];
  long long ev_polish, ev_redo, fold = 0;
  if constexpr (FAST_PATH) {
    tier_add<ST_FAST, K>(ln, cycles(warm, fast));
    tier_add<ST_POLISH, K>(ln, cycles(fast, keep));
    tier_add<ST_REDO, K>(ln, cycles(keep, loop));
    // a redo ran its robust path, which counts one evaluation or more
    const float sv_itv = ln.tr[R + TR_SV];
    const bool redo = sv_itv > 0.0f;
    ev_redo = redo ? (long long)(sv_itv + k) : 0;
    ev_polish = (long long)itv - FAST_ITERS - ev_redo;
    tier_add<ST_REDOS, K>(ln, redo ? 1 : 0);
    tier_add<ST_EV_FAST, K>(ln, FAST_ITERS);
    // each polish's passes after its verdict's first: the first polish
    // made ev_polish, the redo's made k
    if constexpr (FOLDS)
      fold = ev_polish - (long long)ln.tr[R + TR_VB0] - 1 +
             (redo ? (long long)(k - ln.tr[R + TR_VB1]) - 1 : 0);
  } else {
    // the robust path ends at the fast path's mark
    tier_add<ST_REDO, K>(ln, cycles(warm, fast));
    tier_add<ST_POLISH, K>(ln, cycles(fast, loop));
    ev_polish = (long long)k;
    ev_redo = (long long)itv - (long long)k;
    if constexpr (FOLDS) fold = (long long)(k - ln.tr[R + TR_VB0]) - 1;
  }
  tier_add<ST_EV_POLISH, K>(ln, ev_polish);
  tier_add<ST_EV_REDO, K>(ln, ev_redo);
  tier_add<ST_FOLD_PASSES, K>(ln, fold);
  tier_add<ST_COMMIT, K>(ln, cycles(loop, done));
  tier_add<ST_SOLVES, K>(ln, 1);
  tier_add<ST_HOMOTOPY, K>(ln, ln.tick[T + TK_HOMOTOPY]);
  tier_add<ST_DF_RESCUES, K>(ln, ln.tick[T + TK_DF_RESCUE]);
  ln.tick[T + TK_HOMOTOPY] = ln.tick[T + TK_DF_RESCUE] = 0;
  return done;
}

// (in a launch that counts, after each sample) the sample's counters
ACME_FORCEINLINE HD void tier_sample(const Lane& ln) {
  int prev = ln.tick[TS_START];
#define ACME_TIER(S) prev = tier_sub<S>(ln, prev);
  ACME_FOR_EACH_SUB(ACME_TIER)
#undef ACME_TIER
  // the output row and the state update, with the last subsystem's commit
  tier_add<ST_COMMIT, NS1 - 1>(ln, cycles(prev, ln.tick[TS_END]));
}

// (in a launch that counts, at its start) no marks or counts yet
ACME_FORCEINLINE HD void tier_start(const Lane& ln) {
  for (int i = 0; i < NCS; ++i) stat_set(ln, i, 0);
  for (int i = 0; i < TS_START; ++i) ln.tick[i] = 0;
  stat_set(ln, ST_TOTAL * NS1, -launch_clock());
}

}  // namespace acme
