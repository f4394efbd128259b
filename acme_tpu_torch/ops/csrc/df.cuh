// Scalar arithmetic of the fused kernel: float32 helpers with the JAX
// package's semantics, error-free transforms, and double-float ("df")
// pairs -- the per-lane counterpart of acme_tpu/ops/dfmath.py (plain
// version: acme_tpu_torch/ops/dfmath.py).
//
// Rounding must match the plain version, so this file is compiled with
// --fmad=false (nvcc) / -ffp-contract=off (g++) and never with fast math.
// TwoProd's error is one fused multiply-add, fmaf(a, b, -a*b): exact, so it
// equals Dekker's split product of dfmath._two_prod wherever that split
// does not overflow (|a| < 8.3e34, which the element limits guarantee).
#pragma once

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#define HD __host__ __device__
#define ACME_NOINLINE __noinline__
#else
#define HD
#define ACME_NOINLINE __attribute__((noinline))
#endif

// -- float32 with jax.numpy semantics ----------------------------------------

HD inline bool jfinite(float x) { return x - x == 0.0f; }

// jnp.maximum / jnp.minimum propagate NaN (fmaxf/fminf do not)
HD inline float jmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
HD inline float jmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
HD inline float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
HD inline float jsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
HD inline float recip_safe(float v) { return v > 0.0f ? 1.0f / v : 1.0f; }

// -- error-free transforms ---------------------------------------------------

HD inline void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

HD inline void quick_two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  e = b - (s - a);
}

HD inline void two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  e = fmaf(a, b, -p);
}

// One term of a compensated dot product (fused.py dot_df): the float64
// coefficient arrives as a = float32(c) and rem = float32(c - a); the value
// as v (+ its lo part when the value is itself a pair).
template <bool HAS_REM, bool HAS_LO>
HD inline void eft_acc(float& hi, float& lo, float a, float rem, float v,
                       float vlo) {
  float pr = a * v;
  float err = fmaf(a, v, -pr);
  if (HAS_REM) err = err + rem * v;
  if (HAS_LO) err = err + a * vlo;
  float s, e2;
  two_sum(hi, pr, s, e2);
  hi = s;
  lo = lo + (err + e2);
}

// -- double-float pairs -------------------------------------------------------

struct df {
  float hi, lo;
  HD df() : hi(0.0f), lo(0.0f) {}
  HD df(float h) : hi(h), lo(0.0f) {}
  HD df(float h, float l) : hi(h), lo(l) {}
};

HD inline df df_renorm(float hi, float lo) {
  df r;
  quick_two_sum(hi, lo, r.hi, r.lo);
  return r;
}

HD inline df df_add(df a, df b) {
  float s, e;
  two_sum(a.hi, b.hi, s, e);
  e = e + (a.lo + b.lo);
  return df_renorm(s, e);
}

HD inline df df_neg(df a) { return df(-a.hi, -a.lo); }

HD inline df df_sub(df a, df b) { return df_add(a, df_neg(b)); }

HD inline df df_mul(df a, df b) {
  float p, e;
  two_prod(a.hi, b.hi, p, e);
  e = e + (a.hi * b.lo + a.lo * b.hi);
  return df_renorm(p, e);
}

HD inline df df_div(df a, df b) {
  float q0 = a.hi / b.hi;
  float p, e;
  two_prod(q0, b.hi, p, e);
  float r = ((a.hi - p) - e) + a.lo - q0 * b.lo;
  return df_renorm(q0, r / b.hi);
}

HD inline float df_val(df a) { return a.hi + a.lo; }

HD inline bool df_lt(df a, df b) { return (a.hi + a.lo) < (b.hi + b.lo); }
HD inline bool df_le(df a, df b) { return (a.hi + a.lo) <= (b.hi + b.lo); }
HD inline bool df_gt(df a, df b) { return (a.hi + a.lo) > (b.hi + b.lo); }
HD inline bool df_ge(df a, df b) { return (a.hi + a.lo) >= (b.hi + b.lo); }

HD inline df df_sel(bool c, df a, df b) { return c ? a : b; }

HD inline df df_min(df a, df b) { return df_le(a, b) ? a : b; }
HD inline df df_max(df a, df b) { return df_ge(a, b) ? a : b; }

HD inline df df_abs(df x) {
  bool neg = (x.hi + x.lo) < 0.0f;
  return neg ? df(-x.hi, -x.lo) : x;
}

HD inline df df_sign(df x) { return df(jsign(x.hi + x.lo), 0.0f); }

HD inline bool df_finite(df x) { return jfinite(x.hi) && jfinite(x.lo); }

// operators with dfmath.DF's semantics (a float operand is DF(f, 0))
HD inline df operator+(df a, df b) { return df_add(a, b); }
HD inline df operator-(df a, df b) { return df_sub(a, b); }
HD inline df operator*(df a, df b) { return df_mul(a, b); }
HD inline df operator/(df a, df b) { return df_div(a, b); }
HD inline df operator-(df a) { return df_neg(a); }
HD inline df operator*(df a, float b) { return df_mul(a, df(b)); }

HD inline float labs(float v) { return fabsf(v); }
HD inline float labs(df v) { return fabsf(v.hi + v.lo); }

// exact 2**k for integer-valued k in [-126, 126]
HD inline float exp2_exact(float k) {
  float kc = fminf(fmaxf(k, -126.0f), 126.0f);
  int bits = ((int)kc + 127) << 23;
  float r;
  memcpy(&r, &bits, sizeof r);
  return r;
}

// ln 2 and 1/k!, k = 0..12, as exact (hi, lo) float32 splits of the
// float64 values (dfmath._const)
#define ACME_LN2_HI 0x1.62e43p-1f
#define ACME_LN2_LO -0x1.05c61p-29f
#define ACME_INV_LN2 0x1.715476p+0f

HD inline df df_poly_exp(df r) {
  const float ch[13] = {
      0x1p+0f, 0x1p+0f, 0x1p-1f, 0x1.555556p-3f, 0x1.555556p-5f,
      0x1.111112p-7f, 0x1.6c16c2p-10f, 0x1.a01a02p-13f, 0x1.a01a02p-16f,
      0x1.71de3ap-19f, 0x1.27e4fcp-22f, 0x1.ae6456p-26f, 0x1.1eed8ep-29f};
  const float cl[13] = {
      0x0p+0f, 0x0p+0f, 0x0p+0f, -0x1.555556p-28f, -0x1.555556p-30f,
      -0x1.dddddep-32f, -0x1.27d27ep-35f, -0x1.7f97fap-39f, -0x1.7f97fap-42f,
      0x1.55b1ccp-45f, -0x1.10ec14p-47f, 0x1.fd5138p-52f, 0x1.ff1b14p-54f};
  df acc(ch[12], cl[12]);
  for (int k = 11; k >= 0; --k) {
    acc = df_mul(acc, r);
    float s, e;
    two_sum(acc.hi, ch[k], s, e);
    acc = df_renorm(s, e + (acc.lo + cl[k]));
  }
  return acc;
}

HD inline df df_exp_reduced(df x, float& k) {
  float xv = x.hi + x.lo;
  k = rintf(xv * ACME_INV_LN2);
  float p1, e1;
  two_prod(k, ACME_LN2_HI, p1, e1);
  float r_hi, r_e;
  two_sum(x.hi, -p1, r_hi, r_e);
  float r_lo = r_e + x.lo - e1 - k * ACME_LN2_LO;
  return df_poly_exp(df_renorm(r_hi, r_lo));
}

HD inline df df_exp(df x) {
  df xc = df_min(x, df(87.0f));
  xc = df_max(xc, df(-87.0f));
  float k;
  df p = df_exp_reduced(xc, k);
  float s = exp2_exact(k);
  return df(p.hi * s, p.lo * s);
}

HD inline df df_expm1(df x) {
  df xc = df_min(x, df(87.0f));
  xc = df_max(xc, df(-87.0f));
  float k;
  df p = df_exp_reduced(xc, k);
  float s = exp2_exact(k);
  df scaled = df_renorm(p.hi * s, p.lo * s);
  df big = df_sub(scaled, df(1.0f));
  df small = df_renorm(p.hi - 1.0f, p.lo);
  return k == 0.0f ? small : big;
}

HD inline df df_tanh(df x) {
  df a = df_abs(x);
  df em = df_expm1(df(-2.0f * a.hi, -2.0f * a.lo));
  df t = df_div(df_neg(em), df_add(em, df(2.0f)));
  float sgn = jsign(x.hi + x.lo);
  return df(t.hi * sgn, t.lo * sgn);
}

HD inline df df_sqrt(df x) {
  float s = sqrtf(x.hi);
  float p, e;
  two_prod(s, s, p, e);
  float r = ((x.hi - p) - e) + x.lo;
  float corr = s > 0.0f ? r / (2.0f * s) : 0.0f;
  return df_renorm(s, corr);
}
