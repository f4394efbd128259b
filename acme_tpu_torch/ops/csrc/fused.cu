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
//  * The lane's working set on chip, out of local memory.  Its carry
//    (x, z and their lo parts, the warm start, the tolerances and gates,
//    the per-lane coefficients: step.cuh Lane) lives in the block's
//    shared memory as [value][BLOCK], loaded once before the time loop
//    and stored once after it, so the registers hold only the working set
//    of the subsystem being solved.  Every function of the step, the
//    header's element physics in float32 and in df included, is
//    force-inlined, each evaluation mode a template parameter, so no
//    array's address reaches a call; every fixed-size loop is unrolled
//    and the eliminations' pivot cascades are selects (linsolve.cuh), so
//    no array is indexed at run time.  A call or a run-time index would
//    put its arrays (the df 5x5 elimination's matrix, the df physics' q,
//    res and Jq, the lane's carry) in the thread's local-memory frame.
//    The launch bounds let a thread take all 255 registers: at the
//    sweeps' lane counts an SM holds one or a few 32-thread blocks, so
//    registers do not limit occupancy.  What a subsystem's solve writes
//    early and reads again only after long stretches of work (its pfull
//    pair, the sensitivity columns its polish keeps) sits in the carry
//    too.  A subsystem of 7 unknowns (the un-decomposed Super Over) fills
//    the registers with its df system alone: its p and the redo's start
//    wait in the carry as well, compiler barriers keep what its solve
//    reads from the carry from being held in registers across the solve
//    (step.cuh IN_CARRY).  Every elimination of three or more unknowns
//    factors the matrix once, then takes each right-hand column in turn
//    (linsolve.cuh), so the 7x7 df system with six columns holds the
//    matrix, its multipliers and one column.  ptxas reports no frame and
//    no spills for the main
//    production build and the full path's two (chip_smoke.py phase 2
//    holds them there).
//  * Occupancy at 4096 lanes: 4096 threads in 128-thread blocks would
//    occupy 32 of the 132 SMs, so blocks are 32 threads (128 blocks).
//  * Per-lane models (the TPU kernel's _Var tables): the coefficients that
//    differ between the models of a list arrive as two (NVAR, L) tables,
//    hi and lo; a thread reads its NVAR pairs once, coalesced across the
//    warp, and keeps them with its state for the whole run, so the tables
//    cost 8 NVAR bytes of traffic per lane and launch.  Equal coefficients
//    stay literals of the instruction stream, as on the TPU.
//  * Its own tracing (trace.py): a launch handed a stats buffer runs the
//    traced instantiation of the step, which counts, per lane and
//    subsystem, the cycles of each solver tier (the clock at the tier
//    boundaries, where the warp has reconverged) and the events of the
//    rescue ladder in the lane's carry, and adds them to the buffer once
//    at its end; a launch without one runs the step with no tracing code
//    (step.cuh, "the tier counters").  One build holds both.
//  * Lane groups (fast_verify="group" with a fast path, a VERIFY_GROUP
//    build): the TPU kernel decides keep-or-redo once per grid block of
//    lanes, so here the lanes of a group (2048 by default: 64 blocks, more
//    than a thread-block cluster holds) meet at a barrier in device memory
//    at every keep test (step.cuh group_all), one arrival per warp.  A
//    spinning barrier needs every block of the group resident, so these
//    builds launch cooperatively, in batches of as many whole groups as the
//    card holds resident at once (the JAX grid takes its groups one after
//    another too), each batch at its own lane offset on the same stream; a
//    single group the card cannot hold fails rather than run.  The barrier
//    words are (G, 4) ints that the wrapper zeroes before each launch.
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
#include <exception>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using acme::BLOCK;
using acme::cmax1;
using acme::Lane;
using acme::NCF;
using acme::NCF_TR;
using acme::NCI;
using acme::NCI_TR;
using namespace acme_model;

struct Args {
  const float *u, *lanes, *tol, *gate;
  // per-lane coefficient tables (hi, lo), each (max(NVAR, 1), L): lane l's
  // entry i at [i * L + l], so a warp reads neighbouring addresses
  const float *ch, *cl;
  const float *x, *xlo, *z, *zlo, *zw, *wp, *dzdp, *pmode;
  float* y;
  float *xo, *xloo, *zo, *zloo, *zwo, *wpo, *dzdpo, *pmodeo;
  int *fails, *iters, *floored;
  int T, L;
  // the first lane of this launch (a batch of whole lane groups): lanes
  // are indexed from it, the arrays keep their stride L
  int lane0;
  // a VERIFY_GROUP build's lane groups: Lg lanes each, and on the card
  // each group's four barrier words at gwords[4 g]
  int* gwords;
  int Lg;
  // the tier counters (step.cuh Stat), (NSTAT, max(NSUB, 1), L): lane l's
  // counter c of subsystem k at (c * NS1 + k) * L + l, to which the launch
  // adds its own; null: the launch counts nothing
  long long* stats;
};

// set up lane l's place in its lane group (a VERIFY_GROUP build; `host`
// is the group's HostGroup when the lanes run on host threads)
template <class LaneT>
HD inline void join_group(LaneT& ln, const Args& a, int l, void* host) {
  if constexpr (VERIFY_GROUP) {
    ln.gwords = a.gwords + 4 * (l / a.Lg);
    ln.gwarps = a.Lg / 32;
    ln.ghost = host;
    ln.gpar = 0;
  }
}

// one lane's whole run: load its state into its carry (f, n: the first
// float and int of it), step every sample, store it back; TR: the traced
// step, for a launch with a stats buffer
template <bool TR>
ACME_FORCEINLINE HD void run_lane(const Args& a, int l, float* f, int* n,
                                  void* host_group = nullptr) {
  const int L = a.L;
  Lane ln(f, n);
  join_group(ln, a, l, host_group);
  if constexpr (TR) acme::tier_start(ln);
  for (int i = 0; i < NX; ++i) ln.x[i] = a.x[i * L + l], ln.xlo[i] = a.xlo[i * L + l];
  for (int i = 0; i < NNT; ++i) {
    ln.z[i] = a.z[i * L + l];
    ln.zlo[i] = a.zlo[i * L + l];
    ln.zw[i] = a.zw[i * L + l];
  }
  for (int i = 0; i < NPT; ++i) ln.wp[i] = a.wp[i * L + l];
  for (int i = 0; i < NDZ; ++i) ln.dzdp[i] = a.dzdp[i * L + l];
  for (int i = 0; i < NSUB; ++i) {
    ln.pmode[i] = a.pmode[i * L + l];
    ln.tol[i] = a.tol[i * L + l];
    ln.iters[i] = 0;
  }
  for (int i = 0; i < 3 * NSUB; ++i) ln.gate[i] = a.gate[i * L + l];
  for (int i = 0; i < NVAR; ++i) ln.cv[i] = a.ch[i * L + l], ln.cvl[i] = a.cl[i * L + l];
  for (int j = 0; j < NU_L; ++j) ln.lv[j] = a.lanes[j * L + l];
  constexpr int UT = cmax1<NU_T>::v, YR = cmax1<NY>::v;
  ACME_ROLLED
  for (int t = 0; t < a.T; ++t) {
    float yv[YR];
    acme::sample<TR>(ln, a.u + (size_t)t * UT, yv);
    for (int o = 0; o < NY; ++o) a.y[((size_t)t * YR + o) * L + l] = yv[o];
    if constexpr (TR) acme::tier_sample(ln);
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
  for (int i = 0; i < NSUB; ++i) {
    a.pmodeo[i * L + l] = ln.pmode[i];
    a.iters[i * L + l] = ln.iters[i];
  }
  // a model without subsystems: its one pmode row passes through, no
  // iterations
  if (NSUB == 0) a.pmodeo[l] = a.pmode[l], a.iters[l] = 0;
  a.fails[l] = ln.fails;
  a.floored[l] = ln.floored;
  if constexpr (TR) {
    // the lane's whole launch, then its counters added to the buffer
    constexpr int TOTAL = acme::ST_TOTAL * acme::NS1;
    acme::stat_set(ln, TOTAL, acme::stat_get(ln, TOTAL) + acme::launch_clock());
    for (int i = 0; i < acme::NCS; ++i)
      a.stats[(size_t)i * L + l] += acme::stat_get(ln, i);
  }
}

#ifndef __CUDACC__
// the same on the host: the lane's carry in arrays of its own, of the
// traced step's size
inline void run_lane_host(const Args& a, int l, void* host_group = nullptr) {
  float f[NCF_TR];
  int n[NCI_TR];
  if (a.stats)
    run_lane<true>(a, l, f, n, host_group);
  else
    run_lane<false>(a, l, f, n, host_group);
}
#endif

#ifdef __CUDACC__
// the block's carry in static shared memory: the traced step's, the
// larger, must fit the 48 KB a block takes without opting in
constexpr size_t CARRY_BYTES = sizeof(float) * NCF_TR * BLOCK +
                               sizeof(int) * NCI_TR * BLOCK;
static_assert(CARRY_BYTES <= 48 * 1024,
              "the block's carry exceeds 48 KB of static shared memory");
// per-thread stack for the frames of the functions that stay calls
constexpr size_t STACK_BYTES = 16384;

// TR: the traced step, whose carry also holds the tier counters; the
// untraced step's carry is the step's alone
template <bool TR>
__global__ void __launch_bounds__(BLOCK, 1) acme_fused_kernel(Args a) {
  __shared__ float carry_f[(TR ? NCF_TR : NCF) * BLOCK];
  __shared__ int carry_n[(TR ? NCI_TR : NCI) * BLOCK];
  const int t = threadIdx.x;
  const int l = a.lane0 + blockIdx.x * BLOCK + t;
  if (l < a.L) run_lane<TR>(a, l, carry_f + t, carry_n + t);
}

// the kernel a launch runs: the traced step when it has a stats buffer
inline const void* kernel_for(const Args& a) {
  return a.stats ? (const void*)acme_fused_kernel<true>
                 : (const void*)acme_fused_kernel<false>;
}
#endif

// Run `launch(a, n)` over lanes [0, L) in batches of `batch` lanes (whole
// lane groups in a VERIFY_GROUP build), `a.lane0` set to each batch's
// first lane; stops at the first nonzero return and returns it.
template <class F>
int for_batches(Args a, int batch, F launch) {
  for (int l0 = 0; l0 < a.L; l0 += batch) {
    a.lane0 = l0;
    const int e = launch(a, a.L - l0 < batch ? a.L - l0 : batch);
    if (e != 0) return e;
  }
  return 0;
}

Args make_args(const float* u, const float* lanes, const float* tol,
               const float* gate, const float* ch, const float* cl,
               const float* x, const float* xlo,
               const float* z, const float* zlo, const float* zw,
               const float* wp, const float* dzdp, const float* pmode,
               float* y, float* xo, float* xloo, float* zo, float* zloo,
               float* zwo, float* wpo, float* dzdpo, float* pmodeo,
               int* fails, int* iters, int* floored, int T, int L,
               int* gwords, int Lg, long long* stats) {
  Args a;
  a.u = u, a.lanes = lanes, a.tol = tol, a.gate = gate;
  a.ch = ch, a.cl = cl;
  a.x = x, a.xlo = xlo, a.z = z, a.zlo = zlo, a.zw = zw, a.wp = wp;
  a.dzdp = dzdp, a.pmode = pmode, a.y = y;
  a.xo = xo, a.xloo = xloo, a.zo = zo, a.zloo = zloo, a.zwo = zwo;
  a.wpo = wpo, a.dzdpo = dzdpo, a.pmodeo = pmodeo;
  a.fails = fails, a.iters = iters, a.floored = floored;
  a.T = T, a.L = L, a.lane0 = 0;
  a.gwords = gwords, a.Lg = Lg;
  a.stats = stats;
  return a;
}

#ifndef __CUDACC__
// Batched solve_rows for testing linsolve.cuh (acme_solve_host): `count` systems of size n
// (1..5, 7) with m right-hand sides, row-major J (count, n, n), R (count, m,
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

#endif

}  // namespace

#define ACME_ARGS                                                            \
  const float *u, const float *lanes, const float *tol, const float *gate,   \
      const float *ch, const float *cl, const float *x, const float *xlo,    \
      const float *z, const float *zlo, const float *zw, const float *wp,    \
      const float *dzdp, const float *pmode, float *y, float *xo,            \
      float *xloo, float *zo, float *zloo, float *zwo, float *wpo,           \
      float *dzdpo, float *pmodeo, int *fails, int *iters, int *floored,     \
      int T, int L, int *gwords, int Lg, long long *stats
#define ACME_PASS                                                            \
  u, lanes, tol, gate, ch, cl, x, xlo, z, zlo, zw, wp, dzdp, pmode, y, xo,   \
      xloo, zo, zloo, zwo, wpo, dzdpo, pmodeo, fails, iters, floored, T, L,  \
      gwords, Lg, stats

extern "C" {

#ifdef __CUDACC__
// The lanes of whole lane groups of Lg lanes that card `device` holds
// resident at once for this build's step (traced: the traced step's, else
// the untraced one's; 0: not one group), into *lanes; returns a CUDA error
// code.  A cooperative launch needs every block of its grid resident, by
// the same occupancy count.
int acme_resident_lanes(int device, int Lg, int traced, int* lanes) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      traced ? acme_fused_kernel<true> : acme_fused_kernel<false>, BLOCK,
      0);
  if (e != cudaSuccess) return (int)e;
  *lanes = Lg > 0 ? per_sm * sms / ((Lg + BLOCK - 1) / BLOCK) * Lg : 0;
  return 0;
}

// Launch on `stream` of card `device` (the tensors' card); returns a CUDA
// error code (0 on success).  A VERIFY_GROUP build queues cooperative
// launches of as many whole groups as the card holds resident, one after
// another on the stream; cudaErrorCooperativeLaunchTooLarge only when not
// one group fits.
int acme_fused_launch(ACME_ARGS, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex setup;
  static bool stack_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  {
    // the stack limit is a property of each card's context, shared by
    // every library loaded in the process: raise it once, never lower it
    std::lock_guard<std::mutex> lock(setup);
    if (!stack_set[device]) {
      size_t cur = 0;
      e = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
      if (e == cudaSuccess && cur < STACK_BYTES)
        e = cudaDeviceSetLimit(cudaLimitStackSize, STACK_BYTES);
      // both steps loaded now (the runtime loads a kernel at its first
      // launch otherwise), so a traced window does not load one
      cudaFuncAttributes attr;
      if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&attr, acme_fused_kernel<false>);
      if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&attr, acme_fused_kernel<true>);
      if (e != cudaSuccess) return (int)e;
      stack_set[device] = true;
    }
  }
  if (L <= 0) return 0;
  Args a = make_args(ACME_PASS);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (VERIFY_GROUP) {
    int batch = 0;
    e = (cudaError_t)acme_resident_lanes(device, Lg, a.stats != nullptr,
                                         &batch);
    if (e != cudaSuccess) return (int)e;
    if (batch == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    return for_batches(a, batch, [s](Args b, int n) {
      void* params[] = {&b};
      return (int)cudaLaunchCooperativeKernel(
          kernel_for(b), dim3((n + BLOCK - 1) / BLOCK), dim3(BLOCK), params,
          0, s);
    });
  }
  if (a.stats)
    acme_fused_kernel<true><<<(L + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(a);
  else
    acme_fused_kernel<false><<<(L + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The CUDA runtime's name for an error code the launch returned.
const char* acme_cuda_error(int e) {
  return cudaGetErrorName((cudaError_t)e);
}
#endif

// The host entries (the g++ build the tests load; the CUDA library
// carries only the card's, so nvcc compiles no host copy of the step)
#ifndef __CUDACC__
// The same step on the host (tests without a card), in batches of `batch`
// lanes (0: all; a VERIFY_GROUP build's batches are whole groups), each at
// its lane offset as on the card: lane by lane, or in a VERIFY_GROUP build
// each lane of a group on a thread of its own, one group after another;
// returns 1 if a group's threads could not all be started (those that were
// are released from the barrier and joined first), 2 if a group's barrier
// was stuck, 3 for a batch that is not whole groups.
int acme_fused_host(ACME_ARGS, int batch) {
  Args a = make_args(ACME_PASS);
  if (batch <= 0) batch = L;
  if (VERIFY_GROUP && batch % Lg) return 3;
  return for_batches(a, batch, [](const Args& b, int n) {
    if constexpr (VERIFY_GROUP) {
      for (int g0 = b.lane0; g0 < b.lane0 + n; g0 += b.Lg) {
        acme::HostGroup group;
        group.n = b.Lg;
        std::vector<std::thread> lanes_of_group;
        bool started = true;
        try {
          lanes_of_group.reserve(b.Lg);
          for (int l = g0; l < g0 + b.Lg; ++l)
            lanes_of_group.emplace_back([&b, &group, l] {
              run_lane_host(b, l, &group);
            });
        } catch (const std::exception&) {
          started = false;
          std::lock_guard<std::mutex> lock(group.m);
          group.abort = true;
          group.cv.notify_all();
        }
        for (auto& t : lanes_of_group) t.join();
        if (!started) return 1;
        if (group.stuck) return 2;
      }
      return 0;
    }
    for (int l = b.lane0; l < b.lane0 + n; ++l) run_lane_host(b, l);
    return 0;
  });
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
  ACME_CASE(4, 3) ACME_CASE(5, 3) ACME_CASE(7, 6)
#undef ACME_CASE
  return 1;
}

#endif

}  // extern "C"
