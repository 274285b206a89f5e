// The ξ stage of the equilibrium solve with fixed numerics and closed-form
// Stage 1, one thread a cell, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves this stage to XLA, which
// fuses the whole root-find of a cell into one loop. The port ran it as
// eager PyTorch (baseline/solver.py::compute_xi over core/rootfind.py::
// bisect), about 25 launches a bisection step over the whole tile, 2,285 a
// 90-step tile, each paid for on the host. Here one launch does the stage.
//
// Per cell, with G(t) = x0 / (x0 + (1 - x0) * exp((-beta) * t)) and
// f(x) = (G(min(tau_out, x)) - G(min(tau_in, x))) - kappa, where min
// returns a NaN operand as it is (torch.minimum):
//
//   x = 0.5 * (tau_in + tau_out);  lo = tau_in;  hi = tau_out
//   iters times:  pos = f(x) > 0
//                 (x, lo, hi) = (0.5 * (x + (pos ? lo : hi)),
//                                pos ? lo : x,  pos ? x : hi)
//   aw  = G(min(tau_out, x)) - G(min(tau_in, x))
//   err = |aw - kappa|          root_ok = err <= tol
//   increasing = beta*g_o*(1 - g_o) >= beta*g_i*(1 - g_i)  (g at the same two times)
//   and the Health of core/rootfind.py::bisect: residual = err,
//   bracket_width = |hi - lo|, iterations = iters, flags from
//   f(tau_in) * f(tau_out) > 0, a non-finite residual, a NaN end of the
//   bracket and a NaN ξ (the bit values come from the caller).
//
// Rounding: each operation is the one eager PyTorch runs, in its order,
// compiled with -fmad=false and the accurate exp/expf, so every output is
// bit for bit the eager path's on the same card. The loop-invariant -beta
// and 1 - x0 are computed once; each gives the same bits every time.
//
// Inputs are read through strides against the output shape (at most
// kDims dims, 0 where an input broadcasts): the grid's tau_in and tau_out
// are cells, its beta a column, x0 and kappa one value on the device, so
// nothing is copied or read on the host.
//
// What bounds it: operations. A cell reads two values and its row's beta
// and writes eight outputs (34 B in float32, 58 B in float64: 8.5 / 14.5 MB
// a 500x500 tile, 2.5 / 4.3 us at 3.35 TB/s), but each bisection step
// takes two exponentials and two IEEE divisions, ~10^4 instructions a cell
// over 90 steps. chip_smoke.py's xi phase reads the loop's instructions
// from the SASS and gives the bound on the busiest pipe beside the
// measured time (PERF.md).
//
// What the design does about it: the state lives in registers for the
// whole loop; the two evaluations a step share nothing but the
// loop-invariant terms, which are hoisted; the cells are independent, so
// a grid-stride loop of one thread a cell fills the card with no
// synchronisation. The final evaluation's two cdf values serve the
// residual and the slope test both. No allocation, one launch on the
// caller's stream, so a CUDA graph captures it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDims = 4;
constexpr int kInputs = 5;  // tau_in, tau_out, beta, x0, kappa

// The output's shape, padded in front with 1, and each input's strides
// against it, in elements.
struct Layout {
  int64_t size[kDims];
  int64_t stride[kInputs][kDims];
};

// The flag bits of diag/health.py, as the caller passes them.
struct Bits {
  int32_t no_bracket, nonfinite_residual, nan_input, nan_output;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// torch.minimum on the card: a NaN operand is returned as it is.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmin(a, b);
}

// The logistic cdf, logistic_cdf(t, beta, x0) with -beta and 1 - x0 given.
template <typename T>
__device__ __forceinline__ T cdf(T t, T neg_beta, T x0, T one_minus_x0) {
  return x0 / (x0 + one_minus_x0 * exp_t(neg_beta * t));
}

template <typename T>
__global__ void xi_bisect_kernel(const T* __restrict__ tau_in, const T* __restrict__ tau_out,
                                 const T* __restrict__ beta, const T* __restrict__ x0p,
                                 const T* __restrict__ kappa, Layout layout, int64_t n,
                                 int iters, T tol, Bits bits, T* __restrict__ xi_out,
                                 T* __restrict__ err_out, bool* __restrict__ root_ok_out,
                                 bool* __restrict__ increasing_out,
                                 T* __restrict__ residual_out, T* __restrict__ width_out,
                                 int32_t* __restrict__ iterations_out,
                                 int32_t* __restrict__ flags_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t off[kInputs] = {0, 0, 0, 0, 0};
    int64_t rest = i;
#pragma unroll
    for (int d = kDims - 1; d >= 0; --d) {
      const int64_t c = rest % layout.size[d];
      rest /= layout.size[d];
#pragma unroll
      for (int k = 0; k < kInputs; ++k) off[k] += c * layout.stride[k][d];
    }
    const T ti = tau_in[off[0]];
    const T to = tau_out[off[1]];
    const T b = beta[off[2]];
    const T x0 = x0p[off[3]];
    const T k = kappa[off[4]];
    const T nb = -b;
    const T om = static_cast<T>(1) - x0;
    const T half = static_cast<T>(0.5);

    T x = half * (ti + to);
    T lo = ti;
    T hi = to;
    // one step a trip, so the SASS of the loop is one step's instructions
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      const T f = (cdf(nan_min(to, x), nb, x0, om) - cdf(nan_min(ti, x), nb, x0, om)) - k;
      const bool pos = f > static_cast<T>(0);
      const T next = half * (x + (pos ? lo : hi));
      if (pos) {
        hi = x;
      } else {
        lo = x;
      }
      x = next;
    }

    const T g_o = cdf(nan_min(to, x), nb, x0, om);
    const T g_i = cdf(nan_min(ti, x), nb, x0, om);
    const T err = fabs((g_o - g_i) - k);
    const T one = static_cast<T>(1);
    const bool increasing = (b * g_o) * (one - g_o) >= (b * g_i) * (one - g_i);
    const T f_lo = (cdf(nan_min(to, ti), nb, x0, om) - cdf(nan_min(ti, ti), nb, x0, om)) - k;
    const T f_hi = (cdf(nan_min(to, to), nb, x0, om) - cdf(nan_min(ti, to), nb, x0, om)) - k;
    int32_t flags = 0;
    if (f_lo * f_hi > static_cast<T>(0)) flags |= bits.no_bracket;
    if (!isfinite(err)) flags |= bits.nonfinite_residual;
    if (isnan(ti) || isnan(to)) flags |= bits.nan_input;
    if (isnan(x)) flags |= bits.nan_output;

    xi_out[i] = x;
    err_out[i] = err;
    root_ok_out[i] = err <= tol;
    increasing_out[i] = increasing;
    residual_out[i] = err;
    width_out[i] = fabs(hi - lo);
    iterations_out[i] = iters;
    flags_out[i] = flags;
  }
}

constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T>
int launch(const void* tau_in, const void* tau_out, const void* beta, const void* x0,
           const void* kappa, const int64_t* layout, int64_t n, int iters, double tol,
           const int32_t* bits, void* xi, void* err, void* root_ok, void* increasing,
           void* residual, void* width, void* iterations, void* flags, void* stream) {
  if (n <= 0) return 0;
  Layout lay;
  for (int d = 0; d < kDims; ++d) lay.size[d] = layout[d];
  for (int k = 0; k < kInputs; ++k) {
    for (int d = 0; d < kDims; ++d) lay.stride[k][d] = layout[kDims + k * kDims + d];
  }
  const Bits b{bits[0], bits[1], bits[2], bits[3]};
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  xi_bisect_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tau_in), static_cast<const T*>(tau_out),
      static_cast<const T*>(beta), static_cast<const T*>(x0), static_cast<const T*>(kappa),
      lay, n, iters, static_cast<T>(tol), b, static_cast<T*>(xi), static_cast<T*>(err),
      static_cast<bool*>(root_ok), static_cast<bool*>(increasing), static_cast<T*>(residual),
      static_cast<T*>(width), static_cast<int32_t*>(iterations), static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// layout: kDims sizes, then kInputs x kDims strides (host memory, read at
// the launch); bits: the four flag values. Returns cudaGetLastError()
// after the launch (0 on success).
int sbr_xi_bisect_f32(const void* tau_in, const void* tau_out, const void* beta,
                      const void* x0, const void* kappa, const int64_t* layout, int64_t n,
                      int iters, double tol, const int32_t* bits, void* xi, void* err,
                      void* root_ok, void* increasing, void* residual, void* width,
                      void* iterations, void* flags, void* stream) {
  return launch<float>(tau_in, tau_out, beta, x0, kappa, layout, n, iters, tol, bits, xi, err,
                       root_ok, increasing, residual, width, iterations, flags, stream);
}

int sbr_xi_bisect_f64(const void* tau_in, const void* tau_out, const void* beta,
                      const void* x0, const void* kappa, const int64_t* layout, int64_t n,
                      int iters, double tol, const int32_t* bits, void* xi, void* err,
                      void* root_ok, void* increasing, void* residual, void* width,
                      void* iterations, void* flags, void* stream) {
  return launch<double>(tau_in, tau_out, beta, x0, kappa, layout, n, iters, tol, bits, xi,
                        err, root_ok, increasing, residual, width, iterations, flags, stream);
}

}  // extern "C"
