// Per-lane tiny dense solves J X = R (one system per thread), in float32 or
// df -- the per-lane counterpart of _solve_rows / _solve_raw in
// acme_tpu/ops/fused.py (plain version: acme_tpu_torch/ops/linsolve_tiny.py).
// Same operations in the same order: n == 1, 2 closed forms; n >= 3
// inf-norm row/column equilibration, per-lane partial pivoting (the TPU's
// where-select cascade: the running pivot row trades places with each
// later row whose entry is larger), back substitution, and `refine`
// iterative-refinement sweeps.
//
// Every loop is unrolled and every array indexed by constants only (the
// pivot cascade's trades are selects), so on the card the matrix and
// its columns stay in registers: a run-time index would put it in the thread's
// local-memory frame.
//
// From N = 3 up the elimination runs in two parts: the N x N matrix first,
// its pivot trades and multipliers recorded (lu_factor), then each
// right-hand column in turn through the same trades and updates and the
// back substitution (lu_apply).  The cascade at step k reads only column k,
// and a column's update never reads another column, so every element sees
// the same operations on the same operands in the same order as in the JAX
// package's one elimination of the augmented matrix [J | R]: the results
// are bit for bit equal, with the matrix, its multipliers and one column
// live instead of N x (N + M) (the un-decomposed Super Over's 7x7 with six
// right-hand columns would not fit the registers).
#pragma once

#include "df.cuh"

// the index of step k's trade with row i > k among an N x N elimination's
// N (N - 1) / 2 trade decisions
template <int N>
ACME_FORCEINLINE HD constexpr int trade_bit(int k, int i) {
  return k * N - k * (k + 1) / 2 + (i - k - 1);
}

// The elimination of the N x N matrix A alone, in place: the augmented
// elimination's steps on its first N columns.  Records each step's trades (bit trade_bit(k, i)
// of *trades: row i took the running pivot's place), its multipliers
// fct[k][i] (i > k) and the inverse of its pivot; the upper triangle of A
// is left as the augmented elimination leaves it.
template <int N, class T>
ACME_FORCEINLINE HD void lu_factor(T (&A)[N][N], T (&fct)[N][N],
                                   T (&inv)[N], unsigned& trades,
                                   bool pivot) {
  static_assert(N * (N - 1) / 2 <= 32, "trade decisions exceed 32 bits");
  trades = 0u;
  ACME_UNROLL
  for (int k = 0; k < N; ++k) {
    if (pivot) {
      T best[N];
      ACME_UNROLL
      for (int c = k; c < N; ++c) best[c] = A[k][c];
      float best_abs = labs(A[k][k]);
      ACME_UNROLL
      for (int i = k + 1; i < N; ++i) {
        float cand_abs = labs(A[i][k]);
        const bool trade = cand_abs > best_abs;
        trades |= (trade ? 1u : 0u) << trade_bit<N>(k, i);
        ACME_UNROLL
        for (int c = k; c < N; ++c) {
          const T t = best[c];
          best[c] = trade ? A[i][c] : t;
          A[i][c] = trade ? t : A[i][c];
        }
        best_abs = jmax(cand_abs, best_abs);
      }
      ACME_UNROLL
      for (int c = k; c < N; ++c) A[k][c] = best[c];
    }
    inv[k] = T(1.0f) / A[k][k];
    ACME_UNROLL
    for (int i = k + 1; i < N; ++i) {
      fct[k][i] = A[i][k] * inv[k];
      ACME_UNROLL
      for (int c = k + 1; c < N; ++c) A[i][c] = A[i][c] - fct[k][i] * A[k][c];
    }
  }
}

// One right-hand column b through lu_factor's record: each step's trades
// and updates as the augmented elimination makes them on that column, then the back
// substitution into x.
template <int N, class T>
ACME_FORCEINLINE HD void lu_apply(const T (&A)[N][N], const T (&fct)[N][N],
                                  const T (&inv)[N], unsigned trades,
                                  bool pivot, T (&b)[N], T (&x)[N]) {
  ACME_UNROLL
  for (int k = 0; k < N; ++k) {
    if (pivot) {
      T best = b[k];
      ACME_UNROLL
      for (int i = k + 1; i < N; ++i) {
        const bool trade = (trades >> trade_bit<N>(k, i)) & 1u;
        const T t = best;
        best = trade ? b[i] : t;
        b[i] = trade ? t : b[i];
      }
      b[k] = best;
    }
    ACME_UNROLL
    for (int i = k + 1; i < N; ++i) b[i] = b[i] - fct[k][i] * b[k];
  }
  ACME_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    T acc = b[i];
    ACME_UNROLL
    for (int c = i + 1; c < N; ++c) acc = acc - A[i][c] * x[c];
    x[i] = acc * inv[i];
  }
}

// a solution's element as the caller keeps it: as computed, or a df
// collapsed to float
ACME_FORCEINLINE HD void put(float& d, float v) { d = v; }
ACME_FORCEINLINE HD void put(df& d, const df& v) { d = v; }
ACME_FORCEINLINE HD void put(float& d, const df& v) { d = v.hi + v.lo; }

// J X = R.  X may be float where T is df: each element is then collapsed
// (hi + lo) as its column is done.
template <int N, int M, class T, class TX>
ACME_FORCEINLINE HD void solve_rows(const T (&J)[N][N], const T (&R)[M][N],
                                    TX (&X)[M][N], int refine, bool pivot) {
  if constexpr (N == 1) {
    T inv = T(1.0f) / J[0][0];
    ACME_UNROLL
    for (int j = 0; j < M; ++j) put(X[j][0], R[j][0] * inv);
  } else if constexpr (N == 2) {
    T det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    T inv = T(1.0f) / det;
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      put(X[j][0], (R[j][0] * J[1][1] - R[j][1] * J[0][1]) * inv);
      put(X[j][1], (R[j][1] * J[0][0] - R[j][0] * J[1][0]) * inv);
    }
  } else {
    float rs[N], cs[N];
    ACME_UNROLL
    for (int i = 0; i < N; ++i) {
      float mx = labs(J[i][0]);
      ACME_UNROLL
      for (int jj = 1; jj < N; ++jj) mx = jmax(mx, labs(J[i][jj]));
      rs[i] = recip_safe(mx);
    }
    T Js[N][N];
    ACME_UNROLL
    for (int i = 0; i < N; ++i) {
      ACME_UNROLL
      for (int jj = 0; jj < N; ++jj) Js[i][jj] = J[i][jj] * rs[i];
    }
    ACME_UNROLL
    for (int jj = 0; jj < N; ++jj) {
      float mx = labs(Js[0][jj]);
      ACME_UNROLL
      for (int i = 1; i < N; ++i) mx = jmax(mx, labs(Js[i][jj]));
      cs[jj] = recip_safe(mx);
    }
    ACME_UNROLL
    for (int i = 0; i < N; ++i) {
      ACME_UNROLL
      for (int jj = 0; jj < N; ++jj) Js[i][jj] = Js[i][jj] * cs[jj];
    }
    // the matrix once, then each column (and its refinement sweeps, for
    // which the JAX package eliminates the same matrix again) in turn
    T fct[N][N], inv[N];
    unsigned trades;
    lu_factor<N, T>(Js, fct, inv, trades, pivot);
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      T b[N], y[N], x[N];
      ACME_UNROLL
      for (int i = 0; i < N; ++i) b[i] = R[j][i] * rs[i];
      lu_apply<N, T>(Js, fct, inv, trades, pivot, b, y);
      ACME_UNROLL
      for (int jj = 0; jj < N; ++jj) x[jj] = y[jj] * cs[jj];
      for (int it = 0; it < refine; ++it) {
        ACME_UNROLL
        for (int i = 0; i < N; ++i) {
          T acc = R[j][i];
          ACME_UNROLL
          for (int jj = 0; jj < N; ++jj) acc = acc - J[i][jj] * x[jj];
          b[i] = acc * rs[i];
        }
        lu_apply<N, T>(Js, fct, inv, trades, pivot, b, y);
        ACME_UNROLL
        for (int jj = 0; jj < N; ++jj) x[jj] = x[jj] + y[jj] * cs[jj];
      }
      ACME_UNROLL
      for (int jj = 0; jj < N; ++jj) put(X[j][jj], x[jj]);
    }
  }
}
