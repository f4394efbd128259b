// The float64 scan engine for Hopper (sm_90a): a compiled circuit model's
// whole run loop, for thousands of lanes, in one launch.
//
// Replaces the engine's XLA program (not a Pallas kernel): the lax.scan of
// acme_tpu/engine.py:247-279 (CompiledModel._make_scan, _make_sweep_scan,
// and BatchCompiledModel's step), with each subsystem's solve,
// acme_tpu/ops/newton.py _solve_impl, and its eliminations,
// acme_tpu/ops/linsolve.py solve_dense.  Plain version: the step of
// acme_tpu_torch/engine.py (torch ops over lanes, per-lane masks).
//
// What bounds it on this card, and what the design does about it:
//  * Latency-bound per-lane serial work, as the fused kernel (fused.cu): a
//    sample is the ordered chain of the subsystems' Newton loops, each
//    iteration an element-physics evaluation and a pivoted elimination,
//    with data-dependent trip counts and a homotopy loop on failure, and
//    the arithmetic (float64 at tol 1e-12) needs a few bytes of device
//    memory per thousands of operations.  One thread runs one lane for
//    the whole time loop, branching on its own convergence: the masked
//    while_loops of the vmapped JAX solve become this lane's loops, and no
//    lane waits for another beyond its warp.
//  * No local memory: the lane's carry (x, and each subsystem's warm start
//    p, z, dz/dp) lives in shared memory for the whole launch, [NS][BLOCK]
//    (value i of thread t at i * BLOCK + t), loaded once from st_in and
//    stored once to st_out, so the registers hold only the working set of
//    the subsystem being solved; every array is indexed by constants only
//    (dense.cuh swaps pivot rows by selects), so none goes to a stack
//    frame.  ptxas reports no frame and no spills in any build so far.
//  * The model matrices are kernel arguments, one block of NMAT values per
//    lane at a lane stride: 0 for a compiled model, whose block the
//    launch stages into shared memory (every read a broadcast; `fresh`
//    keeps the reads inside the Newton loop, where hoisted they would
//    hold dozens of registers), NMAT for per-lane models, whose blocks
//    stay in device memory, read through the read-only cache.  The
//    wrapper picks the instantiation from the stride and raises where the
//    card cannot give a block the shared memory it needs.  The header
//    holds only the sizes, the block's layout and the element physics
//    (with the entries of Jq it sets to a constant 0, whose products J =
//    Jq Fq and Jq Pexp skip), so one build serves a model at any pot
//    setting, its per-lane variants and any tolerance (a runtime
//    argument).
//  * Outputs are written time-major, y (T, L, NY), converged (T, L),
//    iters (T, L, NSUB), so a warp's stores of one sample coalesce; the
//    wrapper hands them on transposed.
//  * Inputs: each of the model's NU inputs comes from a shared time row
//    (a sweep's audio), a per-lane constant (a sweep's pots) or a per-lane
//    series (run's (L, NU, T)), by a map the wrapper passes; a sweep's
//    input never becomes an (L, NU, T) tensor.
//  * 4096 lanes in 32-thread blocks occupy 128 of the 132 SMs, one warp
//    each.  Fewer lanes to a warp (8 lanes in each of a block's four
//    warps, one warp a scheduler) was measured and lost: four warps on an
//    SM slow each other more than a warp's slowest lane slows it.
//
// Both real types are built (entries _f64 and _f32), the float32 one for
// the engine's dtype=float32.  Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false -shared
// -Xcompiler -fPIC -include <engine header> scan.cu (build.py); the same
// file compiles as C++ with g++ for the host tests.
#include "dense.cuh"
#include "newton.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace acme_engine;

template <class R>
struct Args {
  // (L or 1, NMAT) model blocks, lane l's at mats + l * mat_stride
  const R* mats;
  long long mat_stride;
  // (L, NS) state in and out: x, then per subsystem p, z, dz/dp
  const R* st_in;
  R* st_out;
  // shared time rows: row j, sample t at ut[j * ut_row + t * ut_t]
  const R* ut;
  long long ut_row, ut_t;
  // per-lane series: lane l, row j, sample t at
  // ul[l * ul_lane + j * ul_row + t * ul_t]
  const R* ul;
  long long ul_lane, ul_row, ul_t;
  // per-lane constants: lane l, column j at lv[l * lv_lane + j]
  const R* lv;
  long long lv_lane;
  // where input i comes from: (kind, index) at umap[2 i], kind 0 a time
  // row, 1 a per-lane constant, 2 a per-lane series
  int umap[2 * A1(NU)];
  R* y;
  uint8_t* conv;
  int* iters;
  int T, L;
  Params<R> P;
};

template <class R>
HD inline void assemble_u(const Args<R>& a, int l, int t, R* u) {
  ACME_UNROLL
  for (int i = 0; i < NU; ++i) {
    const int j = a.umap[2 * i + 1];
    switch (a.umap[2 * i]) {
      case 0: u[i] = a.ut[j * a.ut_row + (long long)t * a.ut_t]; break;
      case 1: u[i] = a.lv[l * a.lv_lane + j]; break;
      default:
        u[i] = a.ul[l * a.ul_lane + j * a.ul_row + (long long)t * a.ul_t];
    }
  }
}

// one sample of one lane (engine.py:254-274): the subsystems in order,
// each p from x, u and the z of the earlier ones; then y and x'.  Mb is
// the lane's model block, x and w views of its carry (x, then each
// subsystem's warm start).
template <class R, class M, class C>
HD inline void lane_step(const M& Mb, const C& x, const C& w, const R* u,
                         const Params<R>& P, R* y, bool& conv, int* its) {
  R zacc[A1(NNT)];
  ACME_UNROLL
  for (int i = 0; i < NNT; ++i) zacc[i] = R(0);
  conv = true;
#define ACME_ENGINE_STEP_SUB(S)                                            \
  {                                                                        \
    R p[A1(S::NP)], z[A1(S::NN)];                                          \
    ACME_UNROLL                                                            \
    for (int i = 0; i < S::NP; ++i)                                        \
      p[i] = (dot<NX>(Mb + S::M_DQ + i * NX, 1, x) +                       \
              dot<NU>(Mb + S::M_EQ + i * NU, 1, u)) +                      \
             dot<NNT>(Mb + S::M_FQPREV + i * NNT, 1, zacc);                \
    bool c;                                                                \
    solve_sub<S>(Mb, p, w + S::S_P, w + S::S_Z, w + S::S_D, P, z, c,       \
                 its[S::IDX]);                                             \
    ACME_UNROLL                                                            \
    for (int i = 0; i < S::NN; ++i) zacc[S::OFF + i] = z[i];               \
    conv = conv && c;                                                      \
  }
  ACME_ENGINE_FOR_EACH_SUB(ACME_ENGINE_STEP_SUB)
#undef ACME_ENGINE_STEP_SUB
  ACME_UNROLL
  for (int o = 0; o < NY; ++o)
    y[o] = ((dot<NX>(Mb + M_DY + o * NX, 1, x) +
             dot<NU>(Mb + M_EY + o * NU, 1, u)) +
            dot<NNT>(Mb + M_FY + o * NNT, 1, zacc)) +
           Mb[M_Y0 + o];
  R xn[A1(NX)];
  ACME_UNROLL
  for (int i = 0; i < NX; ++i)
    xn[i] = ((dot<NX>(Mb + M_A + i * NX, 1, x) +
              dot<NU>(Mb + M_B + i * NU, 1, u)) +
             dot<NNT>(Mb + M_C + i * NNT, 1, zacc)) +
            Mb[M_X0 + i];
  ACME_UNROLL
  for (int i = 0; i < NX; ++i) x[i] = xn[i];
}

// one lane's whole run from its carry s (loaded before, stored after):
// step every sample, writing y, converged and iters
template <class R, class M, class C>
HD inline void run_lane(const Args<R>& a, int l, const M& Mb, const C& s) {
  for (int t = 0; t < a.T; ++t) {
    R u[A1(NU)], y[A1(NY)];
    int its[A1(NSUB)];
    bool c;
    assemble_u(a, l, t, u);
    lane_step<R>(fresh(Mb), s, s + NX, u, a.P, y, c, its);
    const long long tl = (long long)t * a.L + l;
    ACME_UNROLL
    for (int o = 0; o < NY; ++o) a.y[tl * NY + o] = y[o];
    a.conv[tl] = c ? 1 : 0;
    ACME_UNROLL
    for (int k = 0; k < NSUB; ++k) a.iters[tl * NSUB + k] = its[k];
  }
}

// the same on the host: the carry a local array (stride 1), the model
// block a plain pointer
template <class R>
void run_lane_host(const Args<R>& a, int l) {
  R s[A1(NS)];
  for (int i = 0; i < NS; ++i) s[i] = a.st_in[(long long)l * NS + i];
  run_lane(a, l, a.mats + l * a.mat_stride, Strided<R, 1>{s});
  for (int i = 0; i < NS; ++i) a.st_out[(long long)l * NS + i] = s[i];
}

// a block on the card: one warp, a lane a thread
constexpr int BLOCK = 32;

// dynamic shared memory of a block: its lanes' carry, [NS][BLOCK], then
// the model block when the lanes share it
template <class R>
constexpr size_t smem_bytes(bool shared_mats) {
  return sizeof(R) * ((size_t)NS * BLOCK + (shared_mats ? NMAT : 0));
}

#ifdef __CUDACC__

// SHARED_MATS: every lane runs the one model block (mat_stride 0), staged
// into shared memory, where every read is a broadcast; else lane l's
// block at mats + l * mat_stride, read through the read-only cache
template <class R, bool SHARED_MATS>
__global__ void __launch_bounds__(BLOCK, 1) acme_scan_kernel(Args<R> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* carry = reinterpret_cast<R*>(smem_raw);
  const int tid = threadIdx.x;
  const long long l0 = (long long)blockIdx.x * BLOCK;
  const int nl = (int)(a.L - l0 < BLOCK ? a.L - l0 : BLOCK);
  // the block's (nl, NS) state rows, read coalesced, into [NS][BLOCK]
  const R* st_in = a.st_in + l0 * NS;
  for (int e = tid; e < nl * NS; e += BLOCK)
    carry[(e % NS) * BLOCK + e / NS] = st_in[e];
  if constexpr (SHARED_MATS) {
    R* mats = carry + NS * BLOCK;
    for (int i = tid; i < NMAT; i += BLOCK) mats[i] = a.mats[i];
  }
  __syncthreads();
  // a thread without a lane leaves now: none waits at a barrier beside a
  // running lane
  if (tid >= nl) return;
  const int l = (int)l0 + tid;
  const Strided<R, BLOCK> s{carry + tid};
  if constexpr (SHARED_MATS)
    run_lane(a, l, (const R*)(carry + NS * BLOCK), s);
  else
    run_lane(a, l, Ldg<R>{a.mats + l * a.mat_stride}, s);
  for (int i = 0; i < NS; ++i) a.st_out[(long long)l * NS + i] = s[i];
}

// returned for a block that needs more shared memory than the card gives
// one (acme_scan_cuda_error names it)
constexpr int SMEM_TOO_LARGE = -2;

template <class R>
int launch(const Args<R>& a, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (a.L <= 0 || a.T <= 0) return 0;
  const bool shared = a.mat_stride == 0;
  const size_t bytes = smem_bytes<R>(shared);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return SMEM_TOO_LARGE;
  void (*kernel)(Args<R>) = acme_scan_kernel<R, false>;
  if (shared) kernel = acme_scan_kernel<R, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(a.L + BLOCK - 1) / BLOCK, BLOCK, bytes, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
#endif

template <class R>
Args<R> make_args(const void* mats, long long mat_stride, const void* st_in,
                  void* st_out, const void* ut, long long ut_row,
                  long long ut_t, const void* ul, long long ul_lane,
                  long long ul_row, long long ul_t, const void* lv,
                  long long lv_lane, const int* umap, void* y, void* conv,
                  void* iters, int T, int L, double tol, int maxiter,
                  int homotopy, int max_homotopy_steps) {
  Args<R> a;
  a.mats = (const R*)mats, a.mat_stride = mat_stride;
  a.st_in = (const R*)st_in, a.st_out = (R*)st_out;
  a.ut = (const R*)ut, a.ut_row = ut_row, a.ut_t = ut_t;
  a.ul = (const R*)ul, a.ul_lane = ul_lane, a.ul_row = ul_row, a.ul_t = ul_t;
  a.lv = (const R*)lv, a.lv_lane = lv_lane;
  for (int i = 0; i < 2 * A1(NU); ++i) a.umap[i] = i < 2 * NU ? umap[i] : 0;
  a.y = (R*)y, a.conv = (uint8_t*)conv, a.iters = (int*)iters;
  a.T = T, a.L = L;
  a.P.tol = (R)tol, a.P.maxiter = maxiter, a.P.homotopy = homotopy != 0;
  a.P.max_homotopy_steps = max_homotopy_steps;
  return a;
}

template <int N, int M, class R>
void dense_batch(int count, const R* J, const R* B, R* X, uint8_t* ok) {
  for (int s = 0; s < count; ++s) {
    R Jl[A1(N)][A1(N)], Bl[A1(N)][A1(M)], Xl[A1(N)][A1(M)];
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) Jl[i][j] = J[(s * N + i) * N + j];
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < M; ++j) Bl[i][j] = B[(s * N + i) * M + j];
    ok[s] = solve_dense<N, M, R>(Jl, Bl, Xl) ? 1 : 0;
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < M; ++j) X[(s * N + i) * M + j] = Xl[i][j];
  }
}

}  // namespace

#define ACME_SCAN_ARGS                                                      \
  const void *mats, long long mat_stride, const void *st_in, void *st_out, \
      const void *ut, long long ut_row, long long ut_t, const void *ul,     \
      long long ul_lane, long long ul_row, long long ul_t, const void *lv,  \
      long long lv_lane, const int *umap, void *y, void *conv, void *iters, \
      int T, int L, double tol, int maxiter, int homotopy,                  \
      int max_homotopy_steps
#define ACME_SCAN_PASS                                                       \
  mats, mat_stride, st_in, st_out, ut, ut_row, ut_t, ul, ul_lane, ul_row,   \
      ul_t, lv, lv_lane, umap, y, conv, iters, T, L, tol, maxiter, homotopy, \
      max_homotopy_steps

extern "C" {

#ifdef __CUDACC__
// Launch on `stream` of card `device` (the tensors' card); returns a CUDA
// error code (0 on success).
int acme_scan_launch_f64(ACME_SCAN_ARGS, int device, void* stream) {
  return launch(make_args<double>(ACME_SCAN_PASS), device, stream);
}
int acme_scan_launch_f32(ACME_SCAN_ARGS, int device, void* stream) {
  return launch(make_args<float>(ACME_SCAN_PASS), device, stream);
}

// The CUDA runtime's name for an error code the launch returned.
const char* acme_scan_cuda_error(int e) {
  if (e == SMEM_TOO_LARGE)
    return "a block's carry and model block exceed the shared memory the "
           "card gives a block (acme_scan_smem_bytes)";
  return cudaGetErrorName((cudaError_t)e);
}
#endif

// Bytes of dynamic shared memory a block of the launch takes: `f64` selects
// the real type, `shared_mats` lanes that share one model block.
long long acme_scan_smem_bytes(int f64, int shared_mats) {
  return (long long)(f64 ? smem_bytes<double>(shared_mats != 0)
                         : smem_bytes<float>(shared_mats != 0));
}

// The same run on the host, lane by lane (tests without a card).
int acme_scan_host_f64(ACME_SCAN_ARGS) {
  const Args<double> a = make_args<double>(ACME_SCAN_PASS);
  for (int l = 0; l < L; ++l) run_lane_host(a, l);
  return 0;
}
int acme_scan_host_f32(ACME_SCAN_ARGS) {
  const Args<float> a = make_args<float>(ACME_SCAN_PASS);
  for (int l = 0; l < L; ++l) run_lane_host(a, l);
  return 0;
}

// solve_dense over `count` systems, for testing dense.cuh: row-major
// J (count, n, n), B and X (count, n, m), ok (count,); `f64` selects the
// real type.  Returns 1 for a size it was not built for.
int acme_dense_host(int n, int m, int count, int f64, const void* J,
                    const void* B, void* X, void* ok) {
#define ACME_CASE(N_, M_)                                                  \
  if (n == N_ && m == M_) {                                                \
    if (f64)                                                               \
      dense_batch<N_, M_, double>(count, (const double*)J, (const double*)B, \
                                  (double*)X, (uint8_t*)ok);               \
    else                                                                   \
      dense_batch<N_, M_, float>(count, (const float*)J, (const float*)B,  \
                                 (float*)X, (uint8_t*)ok);                 \
    return 0;                                                              \
  }
  ACME_CASE(1, 1) ACME_CASE(2, 1) ACME_CASE(3, 1) ACME_CASE(5, 1)
  ACME_CASE(8, 1) ACME_CASE(1, 2) ACME_CASE(2, 2) ACME_CASE(3, 2)
  ACME_CASE(5, 2) ACME_CASE(8, 2)
#undef ACME_CASE
  return 1;
}

}  // extern "C"
