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

// per-lane state carried across samples
struct Lane : GroupOf<VERIFY_GROUP> {
  float x[cmax1<NX>::v], xlo[cmax1<NX>::v];
  float z[cmax1<NNT>::v], zlo[cmax1<NNT>::v], zw[cmax1<NNT>::v];
  float wp[cmax1<NPT>::v], dzdp[cmax1<NDZ>::v], pmode[cmax1<NSUB>::v];
  float tol[cmax1<NSUB>::v], gate[3 * cmax1<NSUB>::v];
  // this lane's per-lane coefficients, loaded once before the time loop
  float cv[cmax1<NVAR>::v], cvl[cmax1<NVAR>::v];
  int iters[cmax1<NSUB>::v];
  int fails, floored;
};

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
HD inline bool group_all(LaneT& ln, bool ok) {
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

// the sample's view of one subsystem: its p, pfull pair and tolerances
template <class S>
struct Ctx {
  static constexpr int NN = S::NN, NQ = S::NQ, NP = cmax1<S::NP>::v;
  float p[NP];
  float pf[NQ], pflo[NQ];
  float ltol, lgate, gate_v, ptol;
  const Lane* ln;
};

template <class S>
struct Eval {
  float res[S::NN];
  float J[S::NN][S::NN];
  float Jq[S::NN * S::NQ];
  float q[S::NQ];
  float resmax, scale;
};

template <class S>
HD inline void eval_stats(Eval<S>& e) {
  float rm = fabsf(e.res[0]);
  for (int a = 1; a < S::NN; ++a) rm = jmax(rm, fabsf(e.res[a]));
  e.resmax = rm;
  float sc = 0.0f;
  for (int a = 0; a < S::NN; ++a) {
    float acc = fabsf(e.Jq[a * S::NQ]) * fabsf(e.q[0]);
    for (int c = 1; c < S::NQ; ++c)
      acc = acc + fabsf(e.Jq[a * S::NQ + c]) * fabsf(e.q[c]);
    sc = a == 0 ? acc : jmax(sc, acc);
  }
  e.scale = sc;
}

// eval_at in plain mode: q = pfull + Fq z (or pf + Fq z for the homotopy)
template <class S>
HD inline void eval_plain(const Ctx<S>& cx, const float* pf,
                          const float (&z)[S::NN], Eval<S>& e, bool stats) {
  const float *cv = cx.ln->cv, *cvl = cx.ln->cvl;
  S::q_plain(cv, cvl, z, pf, e.q);
  S::nl(e.q, e.res, e.Jq);
  S::jac(cv, cvl, e.Jq, &e.J[0][0]);
  if (stats) eval_stats<S>(e);
}

// eval_at in compensated mode: q as an EFT pair, res += Jq q_lo
template <class S>
HD inline void eval_comp(const Ctx<S>& cx, const float (&z)[S::NN],
                         Eval<S>& e) {
  const float *cv = cx.ln->cv, *cvl = cx.ln->cvl;
  float qlo[S::NQ];
  S::q_comp(cv, cvl, z, cx.pf, cx.pflo, e.q, qlo);
  S::nl(e.q, e.res, e.Jq);
  for (int a = 0; a < S::NN; ++a) {
    float acc = e.res[a];
    for (int c = 0; c < S::NQ; ++c) acc = acc + e.Jq[a * S::NQ + c] * qlo[c];
    e.res[a] = acc;
  }
  S::jac(cv, cvl, e.Jq, &e.J[0][0]);
  eval_stats<S>(e);
}

// eval_at in df mode: element physics on (hi, lo) pairs, collapsed; with
// `sys` also the df Newton system (res_df, Jd) for the df elimination
template <class S>
HD inline void eval_df(const Ctx<S>& cx, const float (&z)[S::NN], Eval<S>& e,
                       df* res_df, df (*Jd)[S::NN]) {
  const float *cv = cx.ln->cv, *cvl = cx.ln->cvl;
  float qlo[S::NQ];
  S::q_comp(cv, cvl, z, cx.pf, cx.pflo, e.q, qlo);
  df qd[S::NQ], rd[S::NN], Jqd[S::NN * S::NQ];
  for (int c = 0; c < S::NQ; ++c) qd[c] = df(e.q[c], qlo[c]);
  S::nl_df(qd, rd, Jqd);
  for (int a = 0; a < S::NN; ++a) e.res[a] = rd[a].hi + rd[a].lo;
  for (int i = 0; i < S::NN * S::NQ; ++i) e.Jq[i] = Jqd[i].hi + Jqd[i].lo;
  S::jac(cv, cvl, e.Jq, &e.J[0][0]);
  if (Jd != nullptr) {
    for (int a = 0; a < S::NN; ++a) res_df[a] = rd[a];
    S::jac_df(cv, cvl, Jqd, &Jd[0][0]);
  }
  eval_stats<S>(e);
}

// eval_at with the df residual and the plain Jacobian of the same point
// (fused.py:1240-1254): each half computes only the nodes it needs; only a
// build with that verdict has them (emit.py)
template <class S>
HD inline void eval_dfres(const Ctx<S>& cx, const float (&z)[S::NN],
                          Eval<S>& e) {
  if constexpr (VERDICT == DFRES) {
    const float *cv = cx.ln->cv, *cvl = cx.ln->cvl;
    float qlo[S::NQ];
    S::q_comp(cv, cvl, z, cx.pf, cx.pflo, e.q, qlo);
    df qd[S::NQ], rd[S::NN];
    for (int c = 0; c < S::NQ; ++c) qd[c] = df(e.q[c], qlo[c]);
    S::nl_df_res(qd, rd);
    S::nl_jq(e.q, e.Jq);
    for (int a = 0; a < S::NN; ++a) e.res[a] = rd[a].hi + rd[a].lo;
    S::jac(cv, cvl, e.Jq, &e.J[0][0]);
    eval_stats<S>(e);
  }
}

// eval_at in `mode`, with the df Newton system when `Jd` is given (df mode)
template <class S>
HD inline void eval_mode(const Ctx<S>& cx, const float (&z)[S::NN], int mode,
                         Eval<S>& e, df* res_df, df (*Jd)[S::NN]) {
  if (mode == DFM)
    eval_df<S>(cx, z, e, res_df, Jd);
  else if (mode == DFRES)
    eval_dfres<S>(cx, z, e);
  else if (mode == COMPM)
    eval_comp<S>(cx, z, e);
  else
    eval_plain<S>(cx, cx.pf, z, e, true);
}

template <class S>
HD inline float clipz(float d, int i) {
  return jclip(d, -S::zclip(i), S::zclip(i));
}

template <class S>
HD inline bool all_finite(const float (&v)[S::NN]) {
  bool ok = true;
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
HD inline void run_newton(const Ctx<S>& cx, const float (&zs)[S::NN],
                          Solved<S>& out) {
  float z[S::NN];
  for (int a = 0; a < S::NN; ++a) z[a] = zs[a], out.z[a] = zs[a];
  float prev = 3e38f, strikes = 0.0f, strikes_hi = 0.0f;
  out.r = 3e38f;
  out.g = cx.lgate;
  out.itv = (float)K_NEWTON;
  for (int it = 0; it < K_NEWTON; ++it) {
    Eval<S> e;
    eval_plain<S>(cx, cx.pf, z, e, true);
    float tol_eff = jclip(REL_TOL * e.scale, cx.ltol, 1e4f * cx.ltol);
    float gate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
    float R[1][S::NN], X[1][S::NN];
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
    for (int a = 0; a < S::NN; ++a) out.z[a] = z[a];
    out.r = e.resmax;
    out.g = gate_eff;
    if (done) {
      out.itv = (float)(it + 1);
      break;
    }
    if (move)
      for (int a = 0; a < S::NN; ++a) z[a] = z[a] - clipz<S>(X[0][a], a);
    prev = e.resmax;
  }
}

// bisection homotopy continuation from (wp, zw) (fused.py:1485-1583)
template <class S>
HD inline void homotopy_rescue(const Ctx<S>& cx, Solved<S>& st) {
  constexpr int K2 = 16, TRIPS = 6 * 16;
  const Lane& ln = *cx.ln;
  float z_h[S::NN], z_good[S::NN];
  for (int a = 0; a < S::NN; ++a) {
    z_h[a] = st.z[a];
    z_good[a] = ln.zw[S::OFF + a];
  }
  float a_good = 0.0f, a_try = 1.0f, k_in = 0.0f;
  bool solved = false;
  int trips = 0;
  while (trips < TRIPS && !solved) {
    float pmix[Ctx<S>::NP], pf[S::NQ];
    for (int i = 0; i < S::NP; ++i)
      pmix[i] = ln.wp[S::POFF + i] + a_try * (cx.p[i] - ln.wp[S::POFF + i]);
    S::pf_mix(ln.cv, ln.cvl, pmix, pf);
    Eval<S> e;
    eval_plain<S>(cx, pf, z_h, e, true);
    float gate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
    bool ok = e.resmax < gate_eff;
    float R[1][S::NN], X[1][S::NN];
    for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
    solve_rows<S::NN, 1, float>(e.J, R, X, 0, true);
    bool bad = !jfinite(e.resmax) || !all_finite<S>(X[0]);
    bool move = !(ok || bad);
    float z_new[S::NN];
    for (int a = 0; a < S::NN; ++a)
      z_new[a] = move ? z_h[a] - clipz<S>(X[0][a], a) : z_h[a];
    if (ok) {
      for (int a = 0; a < S::NN; ++a) z_good[a] = z_h[a];
      a_good = a_try;
      if (a_try >= 1.0f) solved = true;
    }
    float k_next = ok ? 0.0f : k_in + 1.0f;
    bool exh = (k_next >= (float)K2) && !ok;
    float a_next = ok ? 1.0f : (exh ? 0.5f * (a_good + a_try) : a_try);
    if (exh) {
      for (int a = 0; a < S::NN; ++a) z_new[a] = z_good[a];
      k_next = 0.0f;
    }
    for (int a = 0; a < S::NN; ++a) z_h[a] = z_new[a];
    a_try = a_next;
    k_in = k_next;
    ++trips;
  }
  if (solved) {
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
  for (int a = 0; a < S::NN; ++a) zs[a] = st.z[a];
  float rm = 3e38f;
  int k = 0;
  while (k < K3 && !(rm < st.g)) {
    Eval<S> e;
    eval_mode<S>(cx, zs, RESCUE_MODE, e, nullptr, nullptr);
    bool ok = e.resmax < st.g;
    float R[1][S::NN], X[1][S::NN];
    for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
    solve_rows<S::NN, 1, float>(e.J, R, X, REFINE, true);
    bool bad = !jfinite(e.resmax) || !all_finite<S>(X[0]);
    if (!(ok || bad))
      for (int a = 0; a < S::NN; ++a) zs[a] = zs[a] - clipz<S>(X[0][a], a);
    rm = e.resmax;
    ++k;
  }
  if ((rm < st.r) || !jfinite(st.r)) {
    for (int a = 0; a < S::NN; ++a) st.z[a] = zs[a];
    st.r = rm;
  }
  st.itv = st.itv + (float)k;
}

template <class S>
ACME_FORCEINLINE HD void full_solve(const Ctx<S>& cx,
                                    const float (&zs)[S::NN], Solved<S>& st) {
  run_newton<S>(cx, zs, st);
  if (!(st.r < st.g)) homotopy_rescue<S>(cx, st);
  if (!(st.r < st.g)) df_rescue<S>(cx, st);
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
// sensitivity columns, in df for the fragile subsystems' df verdict
template <class S, int M>
HD inline void polish_solve(const Eval<S>& e, const df* res_df,
                            const df (*Jd)[S::NN], const float* jp, int rf,
                            float (&X)[M][S::NN]) {
  float R[M][S::NN];
  for (int a = 0; a < S::NN; ++a) R[0][a] = e.res[a];
  for (int b = 0; b + 1 < M; ++b)
    for (int a = 0; a < S::NN; ++a) R[1 + b][a] = jp[b * S::NN + a];
  if (Jd != nullptr) {
    df Jdd[S::NN][S::NN], Rd[M][S::NN], Xd[M][S::NN];
    for (int i = 0; i < S::NN; ++i)
      for (int j = 0; j < S::NN; ++j) Jdd[i][j] = Jd[i][j];
    for (int a = 0; a < S::NN; ++a) Rd[0][a] = res_df[a];
    for (int b = 1; b < M; ++b)
      for (int a = 0; a < S::NN; ++a) Rd[b][a] = df(R[b][a]);
    solve_rows<S::NN, M, df>(Jdd, Rd, Xd, 0, true);
    for (int j = 0; j < M; ++j)
      for (int a = 0; a < S::NN; ++a) X[j][a] = Xd[j][a].hi + Xd[j][a].lo;
  } else {
    solve_rows<S::NN, M, float>(e.J, R, X, rf, true);
  }
}

// one evaluation + shared elimination X = J \ [res | Jp] (fused.py:1652)
template <class S>
HD inline void polish_eval(const Ctx<S>& cx, const float (&z)[S::NN], int mode,
                           bool light, bool verdict, PolishEval<S>& pe) {
  constexpr int NP = Ctx<S>::NP;
  Eval<S> e;
  df res_df[S::NN], Jd[S::NN][S::NN];
  // a df-solve subsystem's df evaluation also builds the df system
  const bool dfsys = S::DF_SLV && mode == DFM;
  eval_mode<S>(cx, z, mode, e, res_df, dfsys ? Jd : nullptr);
  pe.lgate_eff = jclip(REL_GATE * e.scale, cx.lgate, 1e4f * cx.lgate);
  pe.gate_eff_f = jclip(REL_GATE_F * e.scale, cx.gate_v, 1e4f * cx.gate_v);
  pe.tol_pol = jclip(REL_TOL_POL * e.scale, cx.ptol, 1e4f * cx.ptol);
  pe.ltol_eff = jclip(REL_TOL * e.scale, cx.ltol, 1e4f * cx.ltol);
  pe.resmax = e.resmax;
  const int rf = light ? 0 : (verdict ? VREFINE : REFINE);
  const df(*Jdp)[S::NN] = dfsys ? Jd : nullptr;
  // the sensitivity columns ride along while the origin is maintained
  if (EXTRAP && S::NP > 0 && !light) {
    float jp[NP * S::NN], X[1 + NP][S::NN];
    S::jp(cx.ln->cv, cx.ln->cvl, e.Jq, jp);
    polish_solve<S, 1 + NP>(e, res_df, Jdp, jp, rf, X);
    for (int a = 0; a < S::NN; ++a) pe.dz[a] = X[0][a];
    for (int b = 0; b < NP; ++b)
      for (int a = 0; a < S::NN; ++a) pe.cols[b][a] = X[1 + b][a];
  } else {
    float X[1][S::NN];
    polish_solve<S, 1>(e, res_df, Jdp, nullptr, rf, X);
    for (int a = 0; a < S::NN; ++a) pe.dz[a] = X[0][a];
    // NaN placeholder columns: a non-finite verdict then keeps the old
    // sensitivity (the |cols| < 1e6 install bound rejects NaN)
    for (int b = 0; b < NP; ++b)
      for (int a = 0; a < S::NN; ++a) pe.cols[b][a] = NAN;
  }
  pe.fin = jfinite(e.resmax) && all_finite<S>(pe.dz);
}

template <class S>
struct PolishSt {
  float z[S::NN], zlo[S::NN];
  float cols[Ctx<S>::NP][S::NN];
  float rm, rm1, tl1, lg, gf, tp, pfrz, pstall, k;
};

// one verdict pass (fused.py:1898-1948); returns the pre-step residual
template <class S>
HD inline float vd_pass(const Ctx<S>& cx, PolishSt<S>& st) {
  PolishEval<S> pe;
  polish_eval<S>(cx, st.z, S::DF_SLV ? (int)DFM : VERDICT, false, true, pe);
  if (pe.fin) st.tp = pe.tol_pol;
  bool vstep = S::DF_SLV ? pe.fin : (pe.fin && pe.resmax >= pe.tol_pol);
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
    for (int b = 0; b < Ctx<S>::NP; ++b)
      for (int a = 0; a < S::NN; ++a) st.cols[b][a] = pe.cols[b][a];
  }
  st.k = st.k + 1.0f;
  return pe.resmax;
}

// the polish loop (plain, compensated or df) with its unrolled prefix,
// then the verdict, if any, and the fold continuation (fused.py:1750-2016)
template <class S>
ACME_FORCEINLINE HD void polish_all(const Ctx<S>& cx,
                                    const float (&zs)[S::NN], PolishSt<S>& st) {
  for (int a = 0; a < S::NN; ++a) st.z[a] = zs[a], st.zlo[a] = 0.0f;
  for (int b = 0; b < Ctx<S>::NP; ++b)
    for (int a = 0; a < S::NN; ++a) st.cols[b][a] = 0.0f;
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
  for (int it = 0;; ++it) {
    if (it >= nfix &&
        !(st.k < (float)P_POL && !((st.rm < st.tp) || (st.pfrz > 0.5f))))
      break;
    PolishEval<S> pe;
    // with a verdict the loop's steps drop the columns and refinement
    polish_eval<S>(cx, st.z, POL_MODE, VERDICT != NONE, false, pe);
    bool nc = pe.fin && (pe.resmax >= 0.7f * st.rm);
    if (nc) st.pfrz = 1.0f;
    bool unclip = true;
    for (int a = 0; a < S::NN; ++a)
      unclip = unclip && (fabsf(pe.dz[a]) < 0.9f * S::zclip(a));
    if (nc && unclip && (pe.resmax >= pe.tol_pol) &&
        (pe.resmax < 1e3f * pe.gate_eff_f))
      st.pstall = 1.0f;
    bool first = st.k == 0.0f;
    bool act = pe.fin && (pe.resmax >= pe.tol_pol) && (first || st.pfrz < 0.5f);
    if (act)
      for (int a = 0; a < S::NN; ++a) st.z[a] = st.z[a] - clipz<S>(pe.dz[a], a);
    if (first) {
      st.rm1 = pe.resmax;
      st.tl1 = pe.ltol_eff;
    }
    st.rm = pe.resmax;
    st.lg = pe.lgate_eff;
    st.gf = pe.gate_eff_f;
    st.tp = pe.tol_pol;
    for (int b = 0; b < Ctx<S>::NP; ++b)
      for (int a = 0; a < S::NN; ++a) st.cols[b][a] = pe.cols[b][a];
    st.k = st.k + 1.0f;
  }
  if constexpr (VERDICT != NONE) {
    float rm_prev = vd_pass<S>(cx, st);
    if constexpr (S::FOLD) {
      for (int i = 0; i < 9; ++i) {
        if (!((rm_prev >= VTGT) && jfinite(rm_prev))) break;
        PolishSt<S> st2 = st;
        float rm_df = vd_pass<S>(cx, st2);
        bool act = rm_df <= 0.9f * rm_prev;
        rm_prev = act ? rm_df : 0.0f;
        if (act) {
          st = st2;
        } else {
          st.k = st2.k;
        }
      }
    }
  }
}

// -- one subsystem's per-sample solve (fused.py:1072-2266) --------------------

template <class S>
HD inline void solve_sub(Lane& ln, const float* u, float* z_all,
                         float* z_lo_all, bool& any_fail, bool& any_floor) {
  constexpr int NN = S::NN, NP = Ctx<S>::NP;
  Ctx<S> cx;
  cx.ln = &ln;
  cx.ltol = ln.tol[S::IDX];
  cx.lgate = ln.gate[S::IDX];
  cx.gate_v = ln.gate[NSUB + S::IDX];
  cx.ptol = ln.gate[2 * NSUB + S::IDX];
  if constexpr (DF_STATE)
    S::p_of(ln.cv, ln.cvl, ln.x, ln.xlo, u, z_all, z_lo_all, cx.p);
  else
    S::p_plain(ln.cv, ln.cvl, ln.x, u, z_all, cx.p);
  if constexpr (COMP) {
    S::pfull(ln.cv, ln.cvl, cx.p, cx.pf, cx.pflo);
  } else {
    S::pf_mix(ln.cv, ln.cvl, cx.p, cx.pf);
    for (int c = 0; c < S::NQ; ++c) cx.pflo[c] = 0.0f;
  }
  // extrapolated warm start, jump capped at 4 trust regions (with
  // extrapolate "track" or False the start is zw itself)
  float z0[NN];
  for (int i1 = 0; i1 < NN; ++i1) {
    if constexpr (EXTRAP_USE && S::NP > 0) {
      float acc = 0.0f;
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
  PolishSt<S> st;
  float itv;
  if constexpr (!FAST_PATH) {
    // the robust path from the start, then the polish (fused.py:2147-2151)
    Solved<S> sv;
    full_solve<S>(cx, z0, sv);
    polish_all<S>(cx, sv.z, st);
    itv = sv.itv + st.k;
  } else {
    // unguarded fast path with the already-converged guard (no step with
    // polish_only)
    float zs[NN];
    for (int a = 0; a < NN; ++a) zs[a] = z0[a];
    for (int f = 0; f < FAST_ITERS; ++f) {
      Eval<S> e;
      eval_plain<S>(cx, cx.pf, zs, e, false);
      float rmf = fabsf(e.res[0]);
      for (int a = 1; a < NN; ++a) rmf = jmax(rmf, fabsf(e.res[a]));
      float R[1][NN], X[1][NN];
      for (int a = 0; a < NN; ++a) R[0][a] = e.res[a];
      solve_rows<NN, 1, float>(e.J, R, X, 0, PIVOT);
      bool okf = all_finite<S>(X[0]) && (rmf >= cx.ltol);
      if (okf)
        for (int a = 0; a < NN; ++a) zs[a] = zs[a] - clipz<S>(X[0][a], a);
    }
    polish_all<S>(cx, zs, st);
    itv = (float)FAST_ITERS + st.k;
    const float keep_thr = KEEP_TOL ? st.tp : st.gf;
    bool ok1 = (st.rm < keep_thr) || ((st.rm1 < st.tl1) && (st.pstall > 0.5f));
    if (VERIFY_ALWAYS || (VERIFY_GROUP ? !group_all(ln, ok1) : !ok1)) {
      // the redo: for the lanes that failed the keep test ("merge"), for
      // every lane of a group with a lane that failed it ("group"), or for
      // every lane ("always")
      Solved<S> sv;
      full_solve<S>(cx, zs, sv);
      PolishSt<S> st2;
      polish_all<S>(cx, sv.z, st2);
      for (int a = 0; a < NN; ++a) st.z[a] = st2.z[a], st.zlo[a] = st2.zlo[a];
      for (int b = 0; b < NP; ++b)
        for (int a = 0; a < NN; ++a) st.cols[b][a] = st2.cols[b][a];
      st.rm = st2.rm;
      st.gf = st2.gf;
      st.pstall = st2.pstall;
      itv = itv + (sv.itv + st2.k);
    }
  }
  // acceptance, floor certificate, plausibility substitution
  bool z_implaus = false;
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
  for (int a = 0; a < NN; ++a) {
    z_all[S::OFF + a] = zsub ? ln.zw[S::OFF + a] : st.z[a];
    z_lo_all[S::OFF + a] = zsub ? 0.0f : st.zlo[a];
  }
  bool ok = !implaus;
  if (EXTRAP && S::NP > 0) {
    bool okd = ok && conv;
    for (int b = 0; b < S::NP; ++b)
      for (int a = 0; a < NN; ++a) okd = okd && (fabsf(st.cols[b][a]) < 1e6f);
    if (ok) {
      for (int a = 0; a < NN; ++a) ln.zw[S::OFF + a] = st.z[a];
      for (int i = 0; i < S::NP; ++i) ln.wp[S::POFF + i] = cx.p[i];
    }
    if (okd)
      for (int a = 0; a < NN; ++a)
        for (int i = 0; i < S::NP; ++i)
          ln.dzdp[S::DOFF + a * S::NP + i] = -st.cols[i][a];
  } else if (ok) {
    // the position origin follows even without extrapolation
    for (int a = 0; a < NN; ++a) ln.zw[S::OFF + a] = st.z[a];
    for (int i = 0; i < S::NP; ++i) ln.wp[S::POFF + i] = cx.p[i];
  }
}

// one sample: subsystems in chain order, then output row and state update
HD inline void sample(Lane& ln, const float* u_t, const float* lane_vals,
                      float* y) {
  float u[cmax1<NU>::v];
  u_full(u_t, lane_vals, u);
  float z_all[cmax1<NNT>::v], z_lo_all[cmax1<NNT>::v];
  for (int i = 0; i < NNT; ++i) z_all[i] = ln.z[i], z_lo_all[i] = ln.zlo[i];
  bool any_fail = false, any_floor = false;
#define ACME_SOLVE(S) solve_sub<S>(ln, u, z_all, z_lo_all, any_fail, any_floor);
  ACME_FOR_EACH_SUB(ACME_SOLVE)
#undef ACME_SOLVE
  float xn[cmax1<NX>::v], xnlo[cmax1<NX>::v];
  if constexpr (DF_STATE) {
    output_row(ln.cv, ln.cvl, ln.x, ln.xlo, u, z_all, z_lo_all, y);
    state_update(ln.cv, ln.cvl, ln.x, ln.xlo, u, z_all, z_lo_all, xn, xnlo);
  } else {
    // plain read-outs; state and z without lo parts
    output_plain(ln.cv, ln.cvl, ln.x, u, z_all, y);
    state_plain(ln.cv, ln.cvl, ln.x, u, z_all, xn);
    for (int i = 0; i < NX; ++i) xnlo[i] = 0.0f;
    for (int i = 0; i < NNT; ++i) z_lo_all[i] = 0.0f;
  }
  for (int i = 0; i < NX; ++i) ln.x[i] = xn[i], ln.xlo[i] = xnlo[i];
  for (int i = 0; i < NNT; ++i) ln.z[i] = z_all[i], ln.zlo[i] = z_lo_all[i];
  if (NSUB > 0) {
    ln.fails += any_fail ? 1 : 0;
    ln.floored += any_floor ? 1 : 0;
  }
}

}  // namespace acme
