// One lane's solve of one nonlinear subsystem in the float64 scan engine
// (scan.cu): acme_tpu/ops/newton.py's _solve_impl (:106-219), whose masked
// lax.while_loops become this lane's own loops (plain version:
// acme_tpu_torch/ops/newton.py, the same order of operations).
//
// S is a subsystem of the model header (emit.py engine_header): its sizes
// NN, NP, NQ, its matrices' offsets in the lane's matrix block (row-major
// fq (NQ, NN), pexp (NQ, NP), q0 (NQ)) and its element physics
// S::nl<R>(q, res, Jq).  The matrix block Mb is anything indexed like a
// pointer: the block's copy in shared memory, a per-lane block read
// through the read-only cache (Ldg) or a host pointer.  The warm start
// (p, z, dz/dp) is a view of the lane's carry (Strided: shared memory on
// the card), updated in place; the working set of one Newton iteration
// (q, the physics, J, the elimination) lives in registers.
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

// a lane's model block in device memory, read through the read-only cache
template <class R>
struct Ldg {
  const R* p;
  HD R operator[](int i) const {
#ifdef __CUDA_ARCH__
    return __ldg(p + i);
#else
    return p[i];
#endif
  }
  HD Ldg operator+(int o) const { return {p + o}; }
};

// a lane's carry: value i at p[i * STRIDE] (on the card the block's
// [value][lane] layout in shared memory, on the host STRIDE 1)
template <class R, int STRIDE>
struct Strided {
  R* p;
  HD R& operator[](int i) const { return p[i * STRIDE]; }
  HD Strided operator+(int o) const { return {p + o * STRIDE}; }
};

// m itself, through a value the compiler cannot see (on the card): the
// loads made through it cannot be hoisted out of the loop that takes it.
// The model block is loop-invariant, and a shared-memory block's reads
// hoisted out of the Newton loop would hold dozens of values in registers
// across it.
template <class M>
HD inline M fresh(const M& m) {
#ifdef __CUDA_ARCH__
  int zero;
  asm volatile("mov.b32 %0, 0;" : "=r"(zero));
  return m + zero;
#else
  return m;
#endif
}

// sum_j m[j * stride] * v[j] from its first term on; 0 for n == 0
template <int N, class M, class V>
HD inline auto dot(const M& m, int stride, const V& v)
    -> decltype(m[0] * v[0]) {
  using R = decltype(m[0] * v[0]);
  if constexpr (N == 0) {
    return R(0);
  } else {
    R acc = m[0] * v[0];
    ACME_UNROLL
    for (int j = 1; j < N; ++j) acc = acc + m[j * stride] * v[j];
    return acc;
  }
}

// sum_c m[c * stride] * Jq[k0 + c] over the c whose Jq entry the physics
// does not set to a constant 0 (S::jq_nonzero), from the first such term
// on; 0 where there is none.  A skipped term is a 0 times a finite matrix
// entry: the sum differs from the full one at most in the sign of a 0.
template <class S, int N, class M, class R>
HD inline R dot_jq(const M& m, int stride, const R* Jq, int k0) {
  R acc = R(0);
  bool first = true;
  ACME_UNROLL
  for (int c = 0; c < N; ++c) {
    if (S::jq_nonzero(k0 + c)) {
      const R t = m[c * stride] * Jq[k0 + c];
      acc = first ? t : acc + t;
      first = false;
    }
  }
  return acc;
}

// q = pf + Fq z; the element physics there; J = Jq Fq
template <class S, class R, class M>
HD inline void eval_rj(const M& Mb, const R* pf, const R* z,
                       R (&res)[A1(S::NN)], R (&Jq)[A1(S::NN * S::NQ)],
                       R (&J)[A1(S::NN)][A1(S::NN)]) {
  constexpr int NN = S::NN, NQ = S::NQ;
  const auto fq = Mb + S::M_FQ;
  R q[A1(NQ)];
  ACME_UNROLL
  for (int c = 0; c < NQ; ++c) q[c] = pf[c] + dot<NN>(fq + c * NN, 1, z);
  S::template nl<R>(q, res, Jq);
  ACME_UNROLL
  for (int i = 0; i < NN; ++i) {
    ACME_UNROLL
    for (int j = 0; j < NN; ++j)
      J[i][j] = dot_jq<S, NQ>(fq + j, NN, Jq, i * NQ);
  }
}

// Newton from z (updated in place): converged, iterations
template <class S, class R, class M>
HD inline void newton(const M& Mb, const R* pf, R* z, const Params<R>& P,
                      bool& conv, int& it) {
  constexpr int NN = S::NN;
  it = 0;
  conv = NN == 0;
  if constexpr (NN > 0) {
    while (true) {
      R res[A1(NN)], Jq[A1(NN * S::NQ)], J[A1(NN)][A1(NN)];
      eval_rj<S>(fresh(Mb), pf, z, res, Jq, J);
      R resmax = e_abs(res[0]);
      ACME_UNROLL
      for (int i = 1; i < NN; ++i) resmax = e_max(resmax, e_abs(res[i]));
      bool finite = e_finite(resmax);
      ACME_UNROLL
      for (int i = 0; i < NN; ++i) {
        ACME_UNROLL
        for (int j = 0; j < NN; ++j) finite = finite && e_finite(J[i][j]);
      }
      conv = resmax < P.tol;
      it += 1;
      if (conv || !finite) break;
      R Bm[A1(NN)][1], dz[A1(NN)][1];
      ACME_UNROLL
      for (int i = 0; i < NN; ++i) Bm[i][0] = res[i];
      if (!solve_dense<NN, 1>(J, Bm, dz)) break;
      ACME_UNROLL
      for (int i = 0; i < NN; ++i) z[i] = z[i] - dz[i][0];
      if (it >= P.maxiter) break;
    }
  }
}

// -J^-1 Jp at z into d; false where the Jacobian there is singular or
// non-finite (d is then not to be used)
template <class S, class R, class M>
HD inline bool dzdp_at(const M& Mb, const R* pf, const R* z,
                       R (&d)[A1(S::NN)][A1(S::NP)]) {
  constexpr int NN = S::NN, NP = S::NP, NQ = S::NQ;
  R res[A1(NN)], Jq[A1(NN * NQ)], J[A1(NN)][A1(NN)], Bm[A1(NN)][A1(NP)];
  eval_rj<S>(Mb, pf, z, res, Jq, J);
  const auto pexp = Mb + S::M_PEXP;
  ACME_UNROLL
  for (int i = 0; i < NN; ++i) {
    ACME_UNROLL
    for (int b = 0; b < NP; ++b)
      Bm[i][b] = dot_jq<S, NQ>(pexp + b, NP, Jq, i * NQ);
  }
  bool ok = solve_dense<NN, NP>(J, Bm, d);
  ACME_UNROLL
  for (int i = 0; i < NN; ++i) {
    ACME_UNROLL
    for (int b = 0; b < NP; ++b) {
      ok = ok && e_finite(d[i][b]);
      d[i][b] = -d[i][b];
    }
    ACME_UNROLL
    for (int j = 0; j < NN; ++j) ok = ok && e_finite(J[i][j]);
  }
  return ok;
}

// pf = q0 + Pexp p
template <class S, class R, class M>
HD inline void pfull_of(const M& Mb, const R* p, R* pf) {
  const auto pexp = Mb + S::M_PEXP;
  const auto q0 = Mb + S::M_Q0;
  ACME_UNROLL
  for (int c = 0; c < S::NQ; ++c)
    pf[c] = q0[c] + dot<S::NP>(pexp + c * S::NP, 1, p);
}

// z0 = wz + dzdp (p - wp)
template <class S, class R, class W>
HD inline void extrapolate(const W& wp, const W& wz, const W& wd,
                           const R* p, R* z) {
  R dp[A1(S::NP)];
  ACME_UNROLL
  for (int j = 0; j < S::NP; ++j) dp[j] = p[j] - wp[j];
  ACME_UNROLL
  for (int i = 0; i < S::NN; ++i)
    z[i] = wz[i] + dot<S::NP>(wd + i * S::NP, 1, dp);
}

// The subsystem's solve at p from the warm start (wp, wz, wd) (NP, NN,
// NN x NP row-major, views of the lane's carry updated in place): z,
// converged, Newton iterations.
template <class S, class R, class M, class W>
HD inline void solve_sub(const M& Mb, const R* p, const W& wp, const W& wz,
                         const W& wd, const Params<R>& P, R* z, bool& conv,
                         int& iters) {
  constexpr int NN = S::NN, NP = S::NP, NQ = S::NQ;
  R pf[A1(NQ)];
  extrapolate<S>(wp, wz, wd, p, z);
  pfull_of<S>(Mb, p, pf);
  newton<S>(Mb, pf, z, P, conv, iters);
  if (P.homotopy && !conv) {
    // bisection from the warm origin toward p (newton.py:157-210); the
    // fallback origin hw starts as the warm start
    R sp[A1(NP)];
    ACME_UNROLL
    for (int j = 0; j < NP; ++j) sp[j] = wp[j];
    R a = R(0.5), best = R(0);
    int steps = 0;
    bool hc = false;
    while (true) {
      const M Mh = fresh(Mb);
      R pa[A1(NP)], zz[A1(NN)], pfa[A1(NQ)];
      ACME_UNROLL
      for (int j = 0; j < NP; ++j)
        pa[j] = (R(1) - a) * sp[j] + a * p[j];
      extrapolate<S>(wp, wz, wd, pa, zz);
      pfull_of<S>(Mh, pa, pfa);
      bool cc;
      int its;
      newton<S>(Mh, pfa, zz, P, cc, its);
      if (cc) {
        R da[A1(NN)][A1(NP)];
        if (dzdp_at<S>(Mh, pfa, zz, da)) {
          ACME_UNROLL
          for (int j = 0; j < NP; ++j) wp[j] = pa[j];
          ACME_UNROLL
          for (int i = 0; i < NN; ++i) {
            wz[i] = zz[i];
            ACME_UNROLL
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
      ACME_UNROLL
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
      ACME_UNROLL
      for (int j = 0; j < NP; ++j) wp[j] = p[j];
      ACME_UNROLL
      for (int i = 0; i < NN; ++i) {
        wz[i] = z[i];
        ACME_UNROLL
        for (int j = 0; j < NP; ++j) wd[i * NP + j] = d[i][j];
      }
    }
  }
}

}  // namespace acme_engine
