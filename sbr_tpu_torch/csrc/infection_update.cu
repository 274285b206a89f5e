// Fused infection step of the agent simulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel sbr_tpu/social/fused.py::_pallas_update. Per agent
// i, with id = id0 + i:
//
//   (x0, x1) = Threefry2x32(k0, k1; counter = (id, 0))
//   u        = uniform_from_bits(x0, x1)             [0, 1)
//   p        = 1 - exp(((-beta_i) * (counts_i / deg_i)) * dt)
//   newly    = !informed_i && u < p
//   informed'_i = informed_i || newly
//   t_inf'_i    = newly ? t_next : t_inf_i
//
// (k0, k1) are the words of fold_in(key, step) and t_next the time written
// for a newly informed agent, both computed on the host.
//
// What bounds it: memory traffic. Per agent it reads informed (1 B), t_inf,
// counts (4 B), beta and deg, and writes informed' (1 B) and t_inf': 22 B in
// float32, 38 B in float64. Threefry is ~100 integer operations per agent,
// far below the card's integer rate, so at 3.35 TB/s the bound is 6.6 us
// (f32) / 11.3 us (f64) per 10^6 agents.
//
// What the design does about it: one pass, one thread per agent in a
// grid-stride loop, each input read once and each output written once. The
// draw, the hazard and the mask live in registers only; no uniform or mask
// array is materialised, as in the Pallas kernel. The ragged tail is a
// bounds check, so nothing is padded, and the ids array of the Pallas
// kernel is replaced by the scalar id0.
//
// Rounding: compiled with -fmad=false and the accurate exp/expf, in the
// operation order of sbr_tpu's _update_lax, so the kernel and the plain
// PyTorch version (sbr_tpu_torch/social/fused.py::_update_plain) agree bit
// for bit on the same card.
//
// float16 and bfloat16 (half_update_kernel): PyTorch computes each
// operation on a half type in float32 and rounds the result to the type,
// and so does XLA on the CPU for this chain. The kernel does the same, one
// rounding (rt) after every operation, with dt already a value of the type;
// the uniform is the float32 draw rounded to the type and clamped below
// 1.0. Per agent it moves 14 B (informed 1, t_inf 2, counts 4, beta 2,
// deg 2, informed' 1, t_inf' 2): a bound of 4.2 us per 10^6 agents.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = rotl32(x1, r);
  x1 ^= x0;
}

// One Threefry-2x32 block, 20 rounds, as sbr_tpu/social/rng.py::_threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if ((i & 1) == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

template <typename T>
__device__ __forceinline__ T uniform_from_bits(uint32_t x0, uint32_t x1);

template <>
__device__ __forceinline__ float uniform_from_bits<float>(uint32_t x0, uint32_t) {
  return __uint_as_float((x0 >> 9) | 0x3F800000u) - 1.0f;
}

template <>
__device__ __forceinline__ double uniform_from_bits<double>(uint32_t x0, uint32_t x1) {
  const uint64_t bits = (((static_cast<uint64_t>(x0) << 32) | x1) >> 12) |
                        0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
}

// The accurate exponentials, never __expf.
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void infection_update_kernel(
    const uint8_t* __restrict__ informed, const T* __restrict__ t_inf,
    const int32_t* __restrict__ counts, const T* __restrict__ betas,
    const T* __restrict__ safe_deg, uint8_t* __restrict__ informed_out,
    T* __restrict__ t_inf_out, int64_t n, uint32_t id0, uint32_t k0,
    uint32_t k1, T t_next, T dt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t x0, x1;
    threefry2x32(k0, k1, id0 + static_cast<uint32_t>(i), 0u, x0, x1);
    const T u = uniform_from_bits<T>(x0, x1);
    const T frac = static_cast<T>(counts[i]) / safe_deg[i];
    const T p = static_cast<T>(1) - exp_t(((-betas[i]) * frac) * dt);
    const bool was = informed[i] != 0;
    const bool newly = !was && (u < p);
    informed_out[i] = static_cast<uint8_t>(was || newly);
    t_inf_out[i] = newly ? t_next : t_inf[i];
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
// PyTorch operation on H.
template <typename H>
__device__ __forceinline__ float rt(float x) { return to_f32(from_f32<H>(x)); }

// The largest value of H below 1.0: 1 - 2^-11 (float16), 1 - 2^-8
// (bfloat16).
template <typename H>
__device__ __forceinline__ float below_one();
template <>
__device__ __forceinline__ float below_one<__half>() { return 1.0f - 0x1p-11f; }
template <>
__device__ __forceinline__ float below_one<__nv_bfloat16>() { return 1.0f - 0x1p-8f; }

template <typename H>
__global__ void half_update_kernel(
    const uint8_t* __restrict__ informed, const H* __restrict__ t_inf,
    const int32_t* __restrict__ counts, const H* __restrict__ betas,
    const H* __restrict__ safe_deg, uint8_t* __restrict__ informed_out,
    H* __restrict__ t_inf_out, int64_t n, uint32_t id0, uint32_t k0,
    uint32_t k1, H t_next, float dt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t x0, x1;
    threefry2x32(k0, k1, id0 + static_cast<uint32_t>(i), 0u, x0, x1);
    const float u = fminf(rt<H>(uniform_from_bits<float>(x0, x1)), below_one<H>());
    const float frac = rt<H>(rt<H>(static_cast<float>(counts[i])) / to_f32(safe_deg[i]));
    const float rate = rt<H>(rt<H>(-to_f32(betas[i]) * frac) * dt);
    const float p = rt<H>(1.0f - rt<H>(expf(rate)));
    const bool was = informed[i] != 0;
    const bool newly = !was && (u < p);
    informed_out[i] = static_cast<uint8_t>(was || newly);
    t_inf_out[i] = newly ? t_next : t_inf[i];
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T>
int launch(const void* informed, const void* t_inf, const void* counts,
           const void* betas, const void* safe_deg, void* informed_out,
           void* t_inf_out, int64_t n, uint32_t id0, uint32_t k0, uint32_t k1,
           double t_next, double dt, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  infection_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(informed), static_cast<const T*>(t_inf),
      static_cast<const int32_t*>(counts), static_cast<const T*>(betas),
      static_cast<const T*>(safe_deg), static_cast<uint8_t*>(informed_out),
      static_cast<T*>(t_inf_out), n, id0, k0, k1, static_cast<T>(t_next),
      static_cast<T>(dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename H>
int launch_half(const void* informed, const void* t_inf, const void* counts,
                const void* betas, const void* safe_deg, void* informed_out,
                void* t_inf_out, int64_t n, uint32_t id0, uint32_t k0, uint32_t k1,
                double t_next, double dt, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // t_next and dt are values of H (the caller rounds them), so these
  // conversions are exact
  half_update_kernel<H><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(informed), static_cast<const H*>(t_inf),
      static_cast<const int32_t*>(counts), static_cast<const H*>(betas),
      static_cast<const H*>(safe_deg), static_cast<uint8_t*>(informed_out),
      static_cast<H*>(t_inf_out), n, id0, k0, k1,
      from_f32<H>(static_cast<float>(t_next)), static_cast<float>(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int sbr_infection_update_f32(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch<float>(informed, t_inf, counts, betas, safe_deg, informed_out,
                       t_inf_out, n, id0, k0, k1, t_next, dt, stream);
}

int sbr_infection_update_f64(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch<double>(informed, t_inf, counts, betas, safe_deg, informed_out,
                        t_inf_out, n, id0, k0, k1, t_next, dt, stream);
}

int sbr_infection_update_f16(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch_half<__half>(informed, t_inf, counts, betas, safe_deg,
                             informed_out, t_inf_out, n, id0, k0, k1, t_next,
                             dt, stream);
}

int sbr_infection_update_bf16(const void* informed, const void* t_inf,
                              const void* counts, const void* betas,
                              const void* safe_deg, void* informed_out,
                              void* t_inf_out, int64_t n, uint32_t id0,
                              uint32_t k0, uint32_t k1, double t_next, double dt,
                              void* stream) {
  return launch_half<__nv_bfloat16>(informed, t_inf, counts, betas, safe_deg,
                                    informed_out, t_inf_out, n, id0, k0, k1,
                                    t_next, dt, stream);
}

}  // extern "C"
