// Fused Bayesian belief step of the information-model simulation, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel sbr_tpu/social/fused.py::_pallas_belief. Per
// agent i:
//
//   w        = counts_i / deg_i
//   belief'  = fma(dt, fma(w, llr1, (1 - w) * llr0), belief_i)
//   newly    = !informed_i && awareness_i * belief' >= theta_i
//   informed'_i = informed_i || newly
//   t_inf'_i    = newly ? t_next : t_inf_i
//
// The two fused multiply-adds stand where XLA on the CPU puts them when it
// compiles the reference's belief + dt * (w*llr1 + (1-w)*llr0); every other
// operation is rounded on its own (-fmad=false, IEEE division). So the
// kernel and its plain PyTorch version
// (sbr_tpu_torch/social/fused.py::_belief_plain, which emulates each fma
// exactly) agree bit for bit.
//
// What bounds it: memory traffic. Per agent it reads informed (1 B),
// t_inf, belief, counts (4 B), awareness, deg and theta, and writes
// informed' (1 B), t_inf' and belief': 34 B in float32, 62 B in float64.
// About ten floating-point operations an agent are far below the card's
// rate, so at 3.35 TB/s the bound is 10.1 us (f32) / 18.5 us (f64) per
// 10^6 agents.
//
// What the design does about it: one pass, one thread per agent in a
// grid-stride loop, each input read once and each output written once; the
// fraction and the evidence increment live in registers only. The ragged
// tail is a bounds check, so the Pallas kernel's 1024-agent padding with
// inert lanes is not needed, and the scalars (t_next, dt, llr0, llr1) are
// kernel arguments.
//
// float16 and bfloat16 (half_belief_kernel): each operation in float32,
// rounded to the type (rt), as PyTorch and XLA on the CPU compute it. XLA
// contracts the two multiply-adds in float16, each into a float32 fma
// rounded to float16; in bfloat16 it rounds the products and the sums
// each. The scalars are values of the type (the caller rounds them). Per
// agent it moves 20 B (informed 1, t_inf, belief, awareness, deg, theta 2
// each, counts 4, informed' 1, t_inf' and belief' 2 each): 6.0 us per 10^6
// agents at 3.35 TB/s.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void belief_update_kernel(
    const uint8_t* __restrict__ informed, const T* __restrict__ t_inf,
    const T* __restrict__ belief, const int32_t* __restrict__ counts,
    const T* __restrict__ awareness, const T* __restrict__ safe_deg,
    const T* __restrict__ thresholds, uint8_t* __restrict__ informed_out,
    T* __restrict__ t_inf_out, T* __restrict__ belief_out, int64_t n,
    T t_next, T dt, T llr0, T llr1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T w = static_cast<T>(counts[i]) / safe_deg[i];
    const T b2 = fma_t(dt, fma_t(w, llr1, (static_cast<T>(1) - w) * llr0), belief[i]);
    const bool was = informed[i] != 0;
    const bool newly = !was && (awareness[i] * b2 >= thresholds[i]);
    informed_out[i] = static_cast<uint8_t>(was || newly);
    t_inf_out[i] = newly ? t_next : t_inf[i];
    belief_out[i] = b2;
  }
}

__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Also on the host, where the launch converts t_next.
template <typename H>
__host__ __device__ __forceinline__ H from_f32(float x);
template <>
__host__ __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__host__ __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the half type H, back in float32: the result of one
// operation on H.
template <typename H>
__device__ __forceinline__ float rt(float x) { return to_f32(from_f32<H>(x)); }

// a*b + c as XLA on the CPU computes the reference's multiply-add on H.
template <typename H>
__device__ __forceinline__ float madd(float a, float b, float c);
template <>
__device__ __forceinline__ float madd<__half>(float a, float b, float c) {
  return rt<__half>(fmaf(a, b, c));
}
template <>
__device__ __forceinline__ float madd<__nv_bfloat16>(float a, float b, float c) {
  return rt<__nv_bfloat16>(c + rt<__nv_bfloat16>(a * b));
}

template <typename H>
__global__ void half_belief_kernel(
    const uint8_t* __restrict__ informed, const H* __restrict__ t_inf,
    const H* __restrict__ belief, const int32_t* __restrict__ counts,
    const H* __restrict__ awareness, const H* __restrict__ safe_deg,
    const H* __restrict__ thresholds, uint8_t* __restrict__ informed_out,
    H* __restrict__ t_inf_out, H* __restrict__ belief_out, int64_t n,
    H t_next, float dt, float llr0, float llr1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float w = rt<H>(rt<H>(static_cast<float>(counts[i])) / to_f32(safe_deg[i]));
    const float calm = rt<H>(rt<H>(1.0f - w) * llr0);
    const H b2 = from_f32<H>(madd<H>(dt, madd<H>(w, llr1, calm), to_f32(belief[i])));
    const bool was = informed[i] != 0;
    const bool newly =
        !was && (rt<H>(to_f32(awareness[i]) * to_f32(b2)) >= to_f32(thresholds[i]));
    informed_out[i] = static_cast<uint8_t>(was || newly);
    t_inf_out[i] = newly ? t_next : t_inf[i];
    belief_out[i] = b2;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T>
int launch(const void* informed, const void* t_inf, const void* belief,
           const void* counts, const void* awareness, const void* safe_deg,
           const void* thresholds, void* informed_out, void* t_inf_out,
           void* belief_out, int64_t n, double t_next, double dt, double llr0,
           double llr1, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  belief_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(informed), static_cast<const T*>(t_inf),
      static_cast<const T*>(belief), static_cast<const int32_t*>(counts),
      static_cast<const T*>(awareness), static_cast<const T*>(safe_deg),
      static_cast<const T*>(thresholds), static_cast<uint8_t*>(informed_out),
      static_cast<T*>(t_inf_out), static_cast<T*>(belief_out), n,
      static_cast<T>(t_next), static_cast<T>(dt), static_cast<T>(llr0),
      static_cast<T>(llr1));
  return static_cast<int>(cudaGetLastError());
}

template <typename H>
int launch_half(const void* informed, const void* t_inf, const void* belief,
                const void* counts, const void* awareness, const void* safe_deg,
                const void* thresholds, void* informed_out, void* t_inf_out,
                void* belief_out, int64_t n, double t_next, double dt, double llr0,
                double llr1, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the scalars are values of H, so these conversions are exact
  half_belief_kernel<H><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(informed), static_cast<const H*>(t_inf),
      static_cast<const H*>(belief), static_cast<const int32_t*>(counts),
      static_cast<const H*>(awareness), static_cast<const H*>(safe_deg),
      static_cast<const H*>(thresholds), static_cast<uint8_t*>(informed_out),
      static_cast<H*>(t_inf_out), static_cast<H*>(belief_out), n,
      from_f32<H>(static_cast<float>(t_next)), static_cast<float>(dt),
      static_cast<float>(llr0), static_cast<float>(llr1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int sbr_belief_update_f32(const void* informed, const void* t_inf,
                          const void* belief, const void* counts,
                          const void* awareness, const void* safe_deg,
                          const void* thresholds, void* informed_out,
                          void* t_inf_out, void* belief_out, int64_t n,
                          double t_next, double dt, double llr0, double llr1,
                          void* stream) {
  return launch<float>(informed, t_inf, belief, counts, awareness, safe_deg,
                       thresholds, informed_out, t_inf_out, belief_out, n,
                       t_next, dt, llr0, llr1, stream);
}

int sbr_belief_update_f64(const void* informed, const void* t_inf,
                          const void* belief, const void* counts,
                          const void* awareness, const void* safe_deg,
                          const void* thresholds, void* informed_out,
                          void* t_inf_out, void* belief_out, int64_t n,
                          double t_next, double dt, double llr0, double llr1,
                          void* stream) {
  return launch<double>(informed, t_inf, belief, counts, awareness, safe_deg,
                        thresholds, informed_out, t_inf_out, belief_out, n,
                        t_next, dt, llr0, llr1, stream);
}

int sbr_belief_update_f16(const void* informed, const void* t_inf,
                          const void* belief, const void* counts,
                          const void* awareness, const void* safe_deg,
                          const void* thresholds, void* informed_out,
                          void* t_inf_out, void* belief_out, int64_t n,
                          double t_next, double dt, double llr0, double llr1,
                          void* stream) {
  return launch_half<__half>(informed, t_inf, belief, counts, awareness,
                             safe_deg, thresholds, informed_out, t_inf_out,
                             belief_out, n, t_next, dt, llr0, llr1, stream);
}

int sbr_belief_update_bf16(const void* informed, const void* t_inf,
                           const void* belief, const void* counts,
                           const void* awareness, const void* safe_deg,
                           const void* thresholds, void* informed_out,
                           void* t_inf_out, void* belief_out, int64_t n,
                           double t_next, double dt, double llr0, double llr1,
                           void* stream) {
  return launch_half<__nv_bfloat16>(informed, t_inf, belief, counts, awareness,
                                    safe_deg, thresholds, informed_out,
                                    t_inf_out, belief_out, n, t_next, dt, llr0,
                                    llr1, stream);
}

}  // extern "C"
