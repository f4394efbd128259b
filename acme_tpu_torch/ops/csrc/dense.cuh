// Scalar helpers and the small dense solve of the float64 scan engine
// (scan.cu), for either real type R (float or double).
//
// solve_dense<N, M, R> is acme_tpu/ops/linsolve.py's solve_dense for one
// lane (plain version: acme_tpu_torch/ops/linsolve.py), in the same order
// of operations, so the two agree bit for bit: the augmented N x (N + M)
// matrix; the pivot the first maximum of |column| (a NaN counting as the
// largest, the first NaN winning, as jnp.argmax); every row updated at
// every step, rows at or above the pivot with a factor of 0 (so an inf or a
// NaN spreads as in the JAX version); back substitution with each dot
// summed from its first term on.  A zero or non-finite pivot returns false
// (X is then garbage the caller masks out).  It is not the fused kernel's
// linsolve.cuh (row and column equilibration, refinement).
//
// Compiled with --fmad=false (nvcc) / -ffp-contract=off (g++), never with
// fast math: the plain version rounds every product and sum apart.  Every
// loop here is unrolled and every array indexed by constants only (the
// pivot row swap is a select over the rows), so on the card the augmented
// matrix stays in registers: a run-time index would put it in the thread's
// local-memory frame.
#pragma once

#include <math.h>

#ifndef HD
#ifdef __CUDACC__
#define HD __host__ __device__
#else
#define HD
#endif
#endif

// a loop of constant trip count fully unrolled on the card (g++ unrolls as
// it sees fit: nothing there depends on it)
#ifdef __CUDACC__
#define ACME_UNROLL _Pragma("unroll")
#else
#define ACME_UNROLL
#endif

namespace acme_engine {

// an array extent for n entries that may be 0
constexpr int A1(int n) { return n > 0 ? n : 1; }

// -- element physics helpers with jax.numpy semantics ------------------------

HD inline bool e_finite(double x) { return x - x == 0.0; }
HD inline bool e_finite(float x) { return x - x == 0.0f; }

// jnp.maximum / jnp.minimum propagate NaN
template <class R>
HD inline R e_max(R a, R b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <class R>
HD inline R e_min(R a, R b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
template <class R>
HD inline R e_sign(R x) {
  return x > R(0) ? R(1) : (x < R(0) ? R(-1) : x);
}

// exp: float64 exp (libdevice on the card); in float32 on the card expf,
// as torch's float32 exp there, on the host the float64 exp rounded, as the
// plain version rounds it on the CPU (acme_tpu_torch/xp.py)
HD inline double e_exp(double x) { return exp(x); }
HD inline float e_exp(float x) {
#ifdef __CUDA_ARCH__
  return expf(x);
#else
  return (float)exp((double)x);
#endif
}
HD inline double e_expm1(double x) { return expm1(x); }
HD inline float e_expm1(float x) { return expm1f(x); }
HD inline double e_tanh(double x) { return tanh(x); }
HD inline float e_tanh(float x) { return tanhf(x); }
HD inline double e_sqrt(double x) { return sqrt(x); }
HD inline float e_sqrt(float x) { return sqrtf(x); }
HD inline double e_abs(double x) { return fabs(x); }
HD inline float e_abs(float x) { return fabsf(x); }

// -- solve_dense --------------------------------------------------------------

template <int N, int M, class R>
HD inline bool solve_dense(const R (&J)[A1(N)][A1(N)],
                           const R (&B)[A1(N)][A1(M)],
                           R (&X)[A1(N)][A1(M)]) {
  if constexpr (N == 0) {
    return true;
  } else if constexpr (N == 1) {
    const R piv = J[0][0];
    const bool ok = piv != R(0) && e_finite(piv);
    const R safe = piv == R(0) ? R(1) : piv;
    ACME_UNROLL
    for (int j = 0; j < M; ++j) X[0][j] = B[0][j] / safe;
    return ok;
  } else {
    constexpr int W = N + M;
    R A[N][W];
    ACME_UNROLL
    for (int i = 0; i < N; ++i) {
      ACME_UNROLL
      for (int j = 0; j < N; ++j) A[i][j] = J[i][j];
      ACME_UNROLL
      for (int j = 0; j < M; ++j) A[i][N + j] = B[i][j];
    }
    bool ok = true;
    ACME_UNROLL
    for (int k = 0; k < N; ++k) {
      int idx = k;
      R best = e_abs(A[k][k]);
      ACME_UNROLL
      for (int i = k + 1; i < N; ++i) {
        const R v = e_abs(A[i][k]);
        if (!(best != best) && (v > best || v != v)) {
          best = v;
          idx = i;
        }
      }
      ok = ok && best > R(0) && e_finite(best);
      // swap rows k and idx: row k takes row idx's values, row idx row
      // k's, each a select over the rows below k (the same moves as an
      // indexed swap, with constant indices only)
      ACME_UNROLL
      for (int j = 0; j < W; ++j) {
        const R rk = A[k][j];
        R pick = rk;
        ACME_UNROLL
        for (int i = k + 1; i < N; ++i) pick = i == idx ? A[i][j] : pick;
        ACME_UNROLL
        for (int i = k + 1; i < N; ++i) A[i][j] = i == idx ? rk : A[i][j];
        A[k][j] = pick;
      }
      const R piv = A[k][k];
      const R safe = piv == R(0) ? R(1) : piv;
      R rk[W], f[N];
      ACME_UNROLL
      for (int j = 0; j < W; ++j) rk[j] = A[k][j];
      ACME_UNROLL
      for (int i = 0; i < N; ++i) f[i] = i > k ? A[i][k] / safe : R(0);
      ACME_UNROLL
      for (int i = 0; i < N; ++i) {
        ACME_UNROLL
        for (int j = 0; j < W; ++j) A[i][j] = A[i][j] - f[i] * rk[j];
      }
    }
    ACME_UNROLL
    for (int i = N - 1; i >= 0; --i) {
      const R d = A[i][i];
      const R safe = d == R(0) ? R(1) : d;
      ACME_UNROLL
      for (int c = 0; c < M; ++c) {
        R rhs = A[i][N + c];
        if (i + 1 < N) {
          R acc = A[i][i + 1] * X[i + 1][c];
          ACME_UNROLL
          for (int j = i + 2; j < N; ++j) acc = acc + A[i][j] * X[j][c];
          rhs = rhs - acc;
        }
        X[i][c] = rhs / safe;
      }
    }
    return ok;
  }
}

}  // namespace acme_engine
