// One lane's solve of one nonlinear subsystem in the float64 scan engine
// (scan.cu): acme_tpu/ops/newton.py's _solve_impl (:106-219), whose masked
// lax.while_loops become this lane's own loops (plain version:
// acme_tpu_torch/ops/newton.py, the same order of operations).
//
// S is a subsystem of the model header (emit.py engine_header): its sizes
// NN, NP, NQ, its matrices' offsets in the lane's matrix block (row-major
// fq (NQ, NN), pexp (NQ, NP), q0 (NQ)) and its element physics
// S::nl<R>(q, res, Jq).  The warm start (p, z, dz/dp) is the lane's
// registers, updated in place.
#pragma once

#include "dense.cuh"

namespace acme_engine {

template <class R>
struct Params {
  R tol;
  int maxiter;
  bool homotopy;
  int max_homotopy_steps;
};

// sum_j m[j * stride] * v[j] from its first term on; 0 for n == 0
template <int N, class R>
HD inline R dot(const R* m, int stride, const R* v) {
  if constexpr (N == 0) {
    return R(0);
  } else {
    R acc = m[0] * v[0];
    for (int j = 1; j < N; ++j) acc = acc + m[j * stride] * v[j];
    return acc;
  }
}

// q = pf + Fq z; the element physics there; J = Jq Fq
template <class S, class R>
HD inline void eval_rj(const R* Mb, const R* pf, const R* z,
                       R (&res)[A1(S::NN)], R (&Jq)[A1(S::NN * S::NQ)],
                       R (&J)[A1(S::NN)][A1(S::NN)]) {
  constexpr int NN = S::NN, NQ = S::NQ;
  const R* fq = Mb + S::M_FQ;
  R q[A1(NQ)];
  for (int c = 0; c < NQ; ++c) q[c] = pf[c] + dot<NN>(fq + c * NN, 1, z);
  S::template nl<R>(q, res, Jq);
  for (int i = 0; i < NN; ++i)
    for (int j = 0; j < NN; ++j) J[i][j] = dot<NQ>(fq + j, NN, Jq + i * NQ);
}

// Newton from z (updated in place): converged, iterations
template <class S, class R>
HD inline void newton(const R* Mb, const R* pf, R* z, const Params<R>& P,
                      bool& conv, int& it) {
  constexpr int NN = S::NN;
  it = 0;
  conv = NN == 0;
  if constexpr (NN > 0) {
    while (true) {
      R res[A1(NN)], Jq[A1(NN * S::NQ)], J[A1(NN)][A1(NN)];
      eval_rj<S>(Mb, pf, z, res, Jq, J);
      R resmax = e_abs(res[0]);
      for (int i = 1; i < NN; ++i) resmax = e_max(resmax, e_abs(res[i]));
      bool finite = e_finite(resmax);
      for (int i = 0; i < NN; ++i)
        for (int j = 0; j < NN; ++j) finite = finite && e_finite(J[i][j]);
      conv = resmax < P.tol;
      it += 1;
      if (conv || !finite) break;
      R Bm[A1(NN)][1], dz[A1(NN)][1];
      for (int i = 0; i < NN; ++i) Bm[i][0] = res[i];
      if (!solve_dense<NN, 1>(J, Bm, dz)) break;
      for (int i = 0; i < NN; ++i) z[i] = z[i] - dz[i][0];
      if (it >= P.maxiter) break;
    }
  }
}

// -J^-1 Jp at z into d; false where the Jacobian there is singular or
// non-finite (d is then not to be used)
template <class S, class R>
HD inline bool dzdp_at(const R* Mb, const R* pf, const R* z,
                       R (&d)[A1(S::NN)][A1(S::NP)]) {
  constexpr int NN = S::NN, NP = S::NP, NQ = S::NQ;
  R res[A1(NN)], Jq[A1(NN * NQ)], J[A1(NN)][A1(NN)], Bm[A1(NN)][A1(NP)];
  eval_rj<S>(Mb, pf, z, res, Jq, J);
  const R* pexp = Mb + S::M_PEXP;
  for (int i = 0; i < NN; ++i)
    for (int b = 0; b < NP; ++b) Bm[i][b] = dot<NQ>(pexp + b, NP, Jq + i * NQ);
  bool ok = solve_dense<NN, NP>(J, Bm, d);
  for (int i = 0; i < NN; ++i) {
    for (int b = 0; b < NP; ++b) {
      ok = ok && e_finite(d[i][b]);
      d[i][b] = -d[i][b];
    }
    for (int j = 0; j < NN; ++j) ok = ok && e_finite(J[i][j]);
  }
  return ok;
}

// pf = q0 + Pexp p
template <class S, class R>
HD inline void pfull_of(const R* Mb, const R* p, R* pf) {
  const R* pexp = Mb + S::M_PEXP;
  const R* q0 = Mb + S::M_Q0;
  for (int c = 0; c < S::NQ; ++c)
    pf[c] = q0[c] + dot<S::NP>(pexp + c * S::NP, 1, p);
}

// z0 = wz + dzdp (p - wp)
template <class S, class R>
HD inline void extrapolate(const R* wp, const R* wz, const R* wd,
                           const R* p, R* z) {
  R dp[A1(S::NP)];
  for (int j = 0; j < S::NP; ++j) dp[j] = p[j] - wp[j];
  for (int i = 0; i < S::NN; ++i)
    z[i] = wz[i] + dot<S::NP>(wd + i * S::NP, 1, dp);
}

// The subsystem's solve at p from the warm start (wp, wz, wd) (NP, NN,
// NN x NP row-major, updated in place): z, converged, Newton iterations.
template <class S, class R>
HD inline void solve_sub(const R* Mb, const R* p, R* wp, R* wz, R* wd,
                         const Params<R>& P, R* z, bool& conv, int& iters) {
  constexpr int NN = S::NN, NP = S::NP, NQ = S::NQ;
  R pf[A1(NQ)];
  extrapolate<S>(wp, wz, wd, p, z);
  pfull_of<S>(Mb, p, pf);
  newton<S>(Mb, pf, z, P, conv, iters);
  if (P.homotopy && !conv) {
    // bisection from the warm origin toward p (newton.py:157-210); the
    // fallback origin hw starts as the warm start
    R sp[A1(NP)];
    for (int j = 0; j < NP; ++j) sp[j] = wp[j];
    R a = R(0.5), best = R(0);
    int steps = 0;
    bool hc = false;
    while (true) {
      R pa[A1(NP)], zz[A1(NN)], pfa[A1(NQ)];
      for (int j = 0; j < NP; ++j)
        pa[j] = (R(1) - a) * sp[j] + a * p[j];
      extrapolate<S>(wp, wz, wd, pa, zz);
      pfull_of<S>(Mb, pa, pfa);
      bool cc;
      int its;
      newton<S>(Mb, pfa, zz, P, cc, its);
      if (cc) {
        R da[A1(NN)][A1(NP)];
        if (dzdp_at<S>(Mb, pfa, zz, da)) {
          for (int j = 0; j < NP; ++j) wp[j] = pa[j];
          for (int i = 0; i < NN; ++i) {
            wz[i] = zz[i];
            for (int j = 0; j < NP; ++j) wd[i * NP + j] = da[i][j];
          }
        }
      }
      const R best_new = cc ? a : best;
      const R new_a = cc ? R(1) : (a + best) / R(2);
      const bool stuck = !cc && !(best < new_a && new_a < a);
      steps += 1;
      const bool hopeless = best_new <= R(0) && steps >= 32;
      const bool done = best_new >= R(1) || stuck || hopeless ||
                        steps >= P.max_homotopy_steps;
      a = new_a;
      best = best_new;
      for (int i = 0; i < NN; ++i) z[i] = zz[i];
      hc = cc;
      iters += its;
      if (done) break;
    }
    conv = hc;
  }
  // on convergence the origin moves to (p, z), unless the Jacobian there
  // is singular or non-finite (newton.py:212-217)
  if (conv) {
    R d[A1(NN)][A1(NP)];
    if (dzdp_at<S>(Mb, pf, z, d)) {
      for (int j = 0; j < NP; ++j) wp[j] = p[j];
      for (int i = 0; i < NN; ++i) {
        wz[i] = z[i];
        for (int j = 0; j < NP; ++j) wd[i * NP + j] = d[i][j];
      }
    }
  }
}

}  // namespace acme_engine
