// The fused sweep kernel for Hopper (sm_90a): the whole run loop of a
// compiled circuit model, for thousands of lanes, in one launch.
//
// Replaces the TPU kernel of acme_tpu/ops/fused.py: the pl.pallas_call in
// FusedRunner._compiled and its body _build.kernel (per-sample step with
// state in VMEM scratch across a sequential time-chunk grid).  Plain
// version: plain_run in acme_tpu_torch/ops/fused.py.
//
// What bounds it on this card, and what the design does about it:
//  * Latency-bound per-lane serial work.  A sample is a chain of dependent
//    scalar steps (Newton iterations, pivoted eliminations, a rescue
//    ladder) with data-dependent trip counts, and the arithmetic needs
//    ~1 byte of device memory per thousands of flops (state lives on chip
//    for the whole run; only u, y and the state ends touch memory).  So
//    one thread runs one lane for the whole time loop, each thread
//    branching on its own convergence: the TPU's group-wide early exits
//    become per-lane loops, and no lane waits for another.
//  * Register pressure from the 5x5 df elimination (2 floats per entry,
//    6 right-hand columns) and the df element physics.  The heavy tiers
//    (polish, robust path, df rescue, df physics) are separate
//    non-inlined functions, so their frames live in local memory (L1)
//    instead of forcing the whole kernel to its worst-case register count.
//  * Occupancy at 4096 lanes: 4096 threads in 128-thread blocks would
//    occupy 32 of the 132 SMs, so blocks are 32 threads (128 blocks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -include <model header> fused.cu
// (build.py).  The same file compiles as C++ with g++ (the __host__
// __device__ step runs lane by lane on the CPU) for the host tests.
#include "df.cuh"
#include "linsolve.cuh"
#include "step.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

using acme::cmax1;
using acme::Lane;
using namespace acme_model;

struct Args {
  const float *u, *lanes, *tol, *gate;
  const float *x, *xlo, *z, *zlo, *zw, *wp, *dzdp, *pmode;
  float* y;
  float *xo, *xloo, *zo, *zloo, *zwo, *wpo, *dzdpo, *pmodeo;
  int *fails, *iters, *floored;
  int T, L;
};

// one lane's whole run: load its state, step every sample, store it back
HD inline void run_lane(const Args& a, int l) {
  const int L = a.L;
  Lane ln;
  for (int i = 0; i < NX; ++i) ln.x[i] = a.x[i * L + l], ln.xlo[i] = a.xlo[i * L + l];
  for (int i = 0; i < NNT; ++i) {
    ln.z[i] = a.z[i * L + l];
    ln.zlo[i] = a.zlo[i * L + l];
    ln.zw[i] = a.zw[i * L + l];
  }
  for (int i = 0; i < NPT; ++i) ln.wp[i] = a.wp[i * L + l];
  for (int i = 0; i < NDZ; ++i) ln.dzdp[i] = a.dzdp[i * L + l];
  for (int i = 0; i < cmax1<NSUB>::v; ++i) {
    ln.pmode[i] = a.pmode[i * L + l];
    ln.tol[i] = a.tol[i * L + l];
    ln.iters[i] = 0;
  }
  for (int i = 0; i < 3 * cmax1<NSUB>::v; ++i) ln.gate[i] = a.gate[i * L + l];
  ln.fails = 0;
  ln.floored = 0;
  float lv[cmax1<NU_L>::v];
  for (int j = 0; j < NU_L; ++j) lv[j] = a.lanes[j * L + l];
  constexpr int UT = cmax1<NU_T>::v, YR = cmax1<NY>::v;
  for (int t = 0; t < a.T; ++t) {
    float yv[YR];
    acme::sample(ln, a.u + (size_t)t * UT, lv, yv);
    for (int o = 0; o < NY; ++o) a.y[((size_t)t * YR + o) * L + l] = yv[o];
  }
  for (int i = 0; i < NX; ++i) a.xo[i * L + l] = ln.x[i], a.xloo[i * L + l] = ln.xlo[i];
  for (int i = 0; i < NNT; ++i) {
    a.zo[i * L + l] = ln.z[i];
    a.zloo[i * L + l] = ln.zlo[i];
    a.zwo[i * L + l] = ln.zw[i];
  }
  for (int i = 0; i < NPT; ++i) a.wpo[i * L + l] = ln.wp[i];
  for (int i = 0; i < NDZ; ++i) a.dzdpo[i * L + l] = ln.dzdp[i];
  // padding rows (a model without states, z, p or subsystems) pass through
  if (NX == 0) a.xo[l] = a.x[l], a.xloo[l] = a.xlo[l];
  if (NNT == 0) a.zo[l] = a.z[l], a.zloo[l] = a.zlo[l], a.zwo[l] = a.zw[l];
  if (NPT == 0) a.wpo[l] = a.wp[l];
  if (NDZ == 0) a.dzdpo[l] = a.dzdp[l];
  for (int i = 0; i < cmax1<NSUB>::v; ++i) {
    a.pmodeo[i * L + l] = ln.pmode[i];
    a.iters[i * L + l] = ln.iters[i];
  }
  a.fails[l] = ln.fails;
  a.floored[l] = ln.floored;
}

#ifdef __CUDACC__
constexpr int BLOCK = 32;
// per-thread stack for the non-inlined tiers' frames
constexpr size_t STACK_BYTES = 16384;

__global__ void __launch_bounds__(BLOCK) acme_fused_kernel(Args a) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < a.L) run_lane(a, l);
}
#endif

Args make_args(const float* u, const float* lanes, const float* tol,
               const float* gate, const float* x, const float* xlo,
               const float* z, const float* zlo, const float* zw,
               const float* wp, const float* dzdp, const float* pmode,
               float* y, float* xo, float* xloo, float* zo, float* zloo,
               float* zwo, float* wpo, float* dzdpo, float* pmodeo,
               int* fails, int* iters, int* floored, int T, int L) {
  Args a;
  a.u = u, a.lanes = lanes, a.tol = tol, a.gate = gate;
  a.x = x, a.xlo = xlo, a.z = z, a.zlo = zlo, a.zw = zw, a.wp = wp;
  a.dzdp = dzdp, a.pmode = pmode, a.y = y;
  a.xo = xo, a.xloo = xloo, a.zo = zo, a.zloo = zloo, a.zwo = zwo;
  a.wpo = wpo, a.dzdpo = dzdpo, a.pmodeo = pmodeo;
  a.fails = fails, a.iters = iters, a.floored = floored;
  a.T = T, a.L = L;
  return a;
}

// Batched solve_rows for testing linsolve.cuh (acme_solve_host): `count` systems of size n
// (1..5) with m right-hand sides, row-major J (count, n, n), R (count, m,
// n), X (count, m, n); `use_df` reads and writes (hi, lo) pairs from the
// *_lo arrays too.
template <int N, int M>
void solve_batch(int count, int use_df, int refine, int pivot,
                        const float* J, const float* Jlo, const float* R,
                        const float* Rlo, float* X, float* Xlo) {
  for (int s = 0; s < count; ++s) {
    if (use_df) {
      df Jd[N][N], Rd[M][N], Xd[M][N];
      for (int i = 0; i < N; ++i)
        for (int j = 0; j < N; ++j)
          Jd[i][j] = df(J[(s * N + i) * N + j], Jlo[(s * N + i) * N + j]);
      for (int j = 0; j < M; ++j)
        for (int i = 0; i < N; ++i)
          Rd[j][i] = df(R[(s * M + j) * N + i], Rlo[(s * M + j) * N + i]);
      solve_rows<N, M, df>(Jd, Rd, Xd, refine, pivot != 0);
      for (int j = 0; j < M; ++j)
        for (int i = 0; i < N; ++i) {
          X[(s * M + j) * N + i] = Xd[j][i].hi;
          Xlo[(s * M + j) * N + i] = Xd[j][i].lo;
        }
    } else {
      float Jf[N][N], Rf[M][N], Xf[M][N];
      for (int i = 0; i < N; ++i)
        for (int j = 0; j < N; ++j) Jf[i][j] = J[(s * N + i) * N + j];
      for (int j = 0; j < M; ++j)
        for (int i = 0; i < N; ++i) Rf[j][i] = R[(s * M + j) * N + i];
      solve_rows<N, M, float>(Jf, Rf, Xf, refine, pivot != 0);
      for (int j = 0; j < M; ++j)
        for (int i = 0; i < N; ++i) X[(s * M + j) * N + i] = Xf[j][i];
    }
  }
}

}  // namespace

#define ACME_ARGS                                                            \
  const float *u, const float *lanes, const float *tol, const float *gate,   \
      const float *x, const float *xlo, const float *z, const float *zlo,    \
      const float *zw, const float *wp, const float *dzdp,                   \
      const float *pmode, float *y, float *xo, float *xloo, float *zo,       \
      float *zloo, float *zwo, float *wpo, float *dzdpo, float *pmodeo,      \
      int *fails, int *iters, int *floored, int T, int L
#define ACME_PASS                                                            \
  u, lanes, tol, gate, x, xlo, z, zlo, zw, wp, dzdp, pmode, y, xo, xloo, zo, \
      zloo, zwo, wpo, dzdpo, pmodeo, fails, iters, floored, T, L

extern "C" {

#ifdef __CUDACC__
// Launch on `stream` of card `device` (the tensors' card); returns a CUDA
// error code (0 on success).
int acme_fused_launch(ACME_ARGS, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static bool stack_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // the stack limit is a property of each card's context
  if (!stack_set[device]) {
    e = cudaDeviceSetLimit(cudaLimitStackSize, STACK_BYTES);
    if (e != cudaSuccess) return (int)e;
    stack_set[device] = true;
  }
  if (L <= 0) return 0;
  Args a = make_args(ACME_PASS);
  acme_fused_kernel<<<(L + BLOCK - 1) / BLOCK, BLOCK, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

// The same step on the host, lane by lane (tests without a card).
int acme_fused_host(ACME_ARGS) {
  Args a = make_args(ACME_PASS);
  for (int l = 0; l < L; ++l) run_lane(a, l);
  return 0;
}

// Elementwise df arithmetic, for testing df.cuh against its plain version:
// op 0 add, 1 sub, 2 mul, 3 div, 4 exp, 5 expm1, 6 tanh, 7 sqrt, 8 abs,
// 9 min, 10 max, 11 neg.
int acme_df_op_host(int op, int n, const float* ahi, const float* alo,
                    const float* bhi, const float* blo, float* ohi,
                    float* olo) {
  for (int i = 0; i < n; ++i) {
    df a(ahi[i], alo[i]), b(bhi[i], blo[i]), r;
    switch (op) {
      case 0: r = df_add(a, b); break;
      case 1: r = df_sub(a, b); break;
      case 2: r = df_mul(a, b); break;
      case 3: r = df_div(a, b); break;
      case 4: r = df_exp(a); break;
      case 5: r = df_expm1(a); break;
      case 6: r = df_tanh(a); break;
      case 7: r = df_sqrt(a); break;
      case 8: r = df_abs(a); break;
      case 9: r = df_min(a, b); break;
      case 10: r = df_max(a, b); break;
      case 11: r = df_neg(a); break;
      default: return 1;
    }
    ohi[i] = r.hi;
    olo[i] = r.lo;
  }
  return 0;
}

int acme_solve_host(int n, int m, int count, int use_df, int refine,
                    int pivot, const float* J, const float* Jlo,
                    const float* R, const float* Rlo, float* X, float* Xlo) {
#define ACME_CASE(N_, M_)                                              \
  if (n == N_ && m == M_) {                                            \
    solve_batch<N_, M_>(count, use_df, refine, pivot, J, Jlo, R, Rlo, X, \
                        Xlo);                                          \
    return 0;                                                          \
  }
  ACME_CASE(1, 1) ACME_CASE(2, 1) ACME_CASE(3, 1) ACME_CASE(4, 1)
  ACME_CASE(5, 1) ACME_CASE(1, 3) ACME_CASE(2, 3) ACME_CASE(3, 3)
  ACME_CASE(4, 3) ACME_CASE(5, 3)
#undef ACME_CASE
  return 1;
}

}  // extern "C"
