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
// pivot cascade's trades are selects), so on the card the augmented
// matrix stays in registers: a run-time index would put it in the thread's
// local-memory frame.
#pragma once

#include "df.cuh"

template <int N, int M, class T>
ACME_FORCEINLINE HD void solve_raw(const T (&J)[N][N], const T (&R)[M][N],
                                   T (&X)[M][N], bool pivot) {
  constexpr int W = N + M;
  T A[N][W];
  ACME_UNROLL
  for (int i = 0; i < N; ++i) {
    ACME_UNROLL
    for (int c = 0; c < N; ++c) A[i][c] = J[i][c]; {
    ACME_UNROLL
    for (int j = 0; j < M; ++j) A[i][N + j] = R[j][i];
    }
  }
  ACME_UNROLL
  for (int k = 0; k < N; ++k) {
    if (pivot) {
      T best[W];
      ACME_UNROLL
      for (int c = 0; c < W; ++c) best[c] = A[k][c];
      float best_abs = labs(A[k][k]);
      ACME_UNROLL
      for (int i = k + 1; i < N; ++i) {
        float cand_abs = labs(A[i][k]);
        const bool trade = cand_abs > best_abs;
        ACME_UNROLL
        for (int c = 0; c < W; ++c) {
          const T t = best[c];
          best[c] = trade ? A[i][c] : t;
          A[i][c] = trade ? t : A[i][c];
        }
        best_abs = jmax(cand_abs, best_abs);
      }
      ACME_UNROLL
      for (int c = 0; c < W; ++c) A[k][c] = best[c];
    }
    T inv = T(1.0f) / A[k][k];
    ACME_UNROLL
    for (int i = k + 1; i < N; ++i) {
      T fct = A[i][k] * inv;
      ACME_UNROLL
      for (int c = k; c < W; ++c) A[i][c] = A[i][c] - fct * A[k][c]; {
      ACME_UNROLL
      for (int c = 0; c < k; ++c) A[i][c] = T(0.0f);
      }
    }
  }
  ACME_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    T inv = T(1.0f) / A[i][i];
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      T acc = A[i][N + j];
      ACME_UNROLL
      for (int c = i + 1; c < N; ++c) acc = acc - A[i][c] * X[j][c];
      X[j][i] = acc * inv;
    }
  }
}

template <int N, int M, class T>
ACME_FORCEINLINE HD void solve_rows(const T (&J)[N][N], const T (&R)[M][N],
                                    T (&X)[M][N], int refine, bool pivot) {
  if constexpr (N == 1) {
    T inv = T(1.0f) / J[0][0];
    ACME_UNROLL
    for (int j = 0; j < M; ++j) X[j][0] = R[j][0] * inv;
  } else if constexpr (N == 2) {
    T det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    T inv = T(1.0f) / det;
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      X[j][0] = (R[j][0] * J[1][1] - R[j][1] * J[0][1]) * inv;
      X[j][1] = (R[j][1] * J[0][0] - R[j][0] * J[1][0]) * inv;
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
    T Rs[M][N], Y[M][N];
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      ACME_UNROLL
      for (int i = 0; i < N; ++i) Rs[j][i] = R[j][i] * rs[i];
    }
    solve_raw<N, M, T>(Js, Rs, Y, pivot);
    ACME_UNROLL
    for (int j = 0; j < M; ++j) {
      ACME_UNROLL
      for (int jj = 0; jj < N; ++jj) X[j][jj] = Y[j][jj] * cs[jj];
    }
    for (int it = 0; it < refine; ++it) {
      ACME_UNROLL
      for (int j = 0; j < M; ++j) {
        ACME_UNROLL
        for (int i = 0; i < N; ++i) {
          T acc = R[j][i];
          ACME_UNROLL
          for (int jj = 0; jj < N; ++jj) acc = acc - J[i][jj] * X[j][jj];
          Rs[j][i] = acc * rs[i];
        }
      }
      solve_raw<N, M, T>(Js, Rs, Y, pivot);
      ACME_UNROLL
      for (int j = 0; j < M; ++j) {
        ACME_UNROLL
        for (int jj = 0; jj < N; ++jj)
          X[j][jj] = X[j][jj] + Y[j][jj] * cs[jj];
      }
    }
  }
}
