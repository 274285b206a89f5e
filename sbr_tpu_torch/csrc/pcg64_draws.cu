// numpy's PCG64 streams drawn on the card, for Hopper (sm_90a): the two
// draws of a rewired simulation that numpy makes on one host thread.
//
//   pcg64_indegree_pass: the in-degrees of a uniform destination marginal,
//     the histogram of the first E ids of Generator(PCG64).integers(0, n),
//     equal to np.bincount of the host draw entry for entry. Replaces the
//     host draw of sbr_tpu_torch/social/graphgen.py::epoch_indegrees for
//     the device (~10^8 ids an epoch at 10^7 agents: the rewired run's
//     longest stage, and one whose time swings with the host's load).
//   pcg64_bernoulli: Generator(PCG64).random(n) < p, the initial informed
//     mask of sbr_tpu_torch/social/agents.py::_draw_seeds (10^7 doubles a
//     simulation, while the card waits).
//
// numpy's stream, as its C sources define it:
//
//   state'  = state * M + inc (mod 2^128), M = 0x2360ED051FC65DA4_4385DF649FCCF645
//   output  = rotr64(hi(state') ^ lo(state'), state' >> 122)        (XSL-RR)
//   double  = (output >> 11) * 2^-53                                 (random)
//   words   = low 32 bits of each output, then its high 32 bits (the bit
//             generator keeps the high half for its next 32-bit call, so
//             chunked draws continue one word stream)
//   id      = (w * n) >> 32 for a word w whose (w * n) mod 2^32 is at
//             least (2^32 - n) mod n; a word below that is skipped
//             (Lemire's rejection, about n / 2^32 of the words at most)
//
// so the ids are the accepted words in order, and node j's in-degree counts
// the first E accepted words whose id is j. The caller reads the starting
// state and inc from numpy's own bit generator.
//
// Design: thread t owns outputs [t P, t P + P) of the stream, and jumps to
// its first state with PCG's logarithmic advance (about 2 log2(t P)
// 128-bit products), then steps. The Bernoulli draw writes one byte an
// output. The in-degrees take a stream of W words, the caller's W holding E
// accepted words with 20 standard deviations to spare: pass 1 counts each
// thread's accepted words; the caller's exclusive prefix sum gives each
// thread the index of its first accepted word; pass 2 steps the same words
// again and adds one to the histogram for each accepted word whose index
// is below E. The additions are integer atomics, so the histogram does not
// depend on their order.
//
// What bounds it: the in-degrees' E random increments of an n-entry int32
// table (40 MB at 10^7 agents, within the 50 MB L2), and the two passes'
// integer work, about 16 instructions a word (one 128-bit multiply-add an
// output); the Bernoulli draw's n bytes of writes and its one 128-bit
// multiply-add an agent. Neither reads more than per-thread counts and
// offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ U128 mul128(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo * b.lo;
  r.hi = __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo;
  return r;
}

__device__ __forceinline__ U128 add128(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1u : 0u);
  return r;
}

constexpr uint64_t kMulHi = 0x2360ED051FC65DA4ULL;
constexpr uint64_t kMulLo = 0x4385DF649FCCF645ULL;
constexpr int64_t kOutputs = 256;  // 64-bit outputs a thread: 512 words
constexpr int kThreads = 256;

// The state ``delta`` steps after ``s`` (PCG's pcg_advance_lcg_128).
__device__ U128 advance(U128 s, uint64_t delta, U128 inc) {
  U128 mult{kMulHi, kMulLo}, plus = inc;
  U128 acc_mult{0, 1}, acc_plus{0, 0};
  while (delta) {
    if (delta & 1u) {
      acc_mult = mul128(acc_mult, mult);
      acc_plus = add128(mul128(acc_plus, mult), plus);
    }
    plus = mul128(add128(mult, U128{0, 1}), plus);
    mult = mul128(mult, mult);
    delta >>= 1;
  }
  return add128(mul128(acc_mult, s), acc_plus);
}

__device__ __forceinline__ uint64_t xsl_rr(U128 s) {
  const uint64_t x = s.hi ^ s.lo;
  const unsigned rot = static_cast<unsigned>(s.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// COUNT: accepted[t] = thread t's accepted words. Else: one histogram
// increment for each accepted word whose index (first[t] onward) is < e.
template <bool COUNT>
__global__ void __launch_bounds__(kThreads) indegree_kernel(
    U128 s0, U128 inc, uint32_t n, uint32_t threshold, int64_t words,
    int32_t* __restrict__ accepted, const int64_t* __restrict__ first, int64_t e,
    int32_t* __restrict__ hist) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t w0 = t * 2 * kOutputs;
  if (w0 >= words) return;
  const int64_t w_end = min(words, w0 + 2 * kOutputs);
  int64_t k = COUNT ? 0 : first[t];
  if (!COUNT && k >= e) return;
  const U128 mult{kMulHi, kMulLo};
  U128 s = advance(s0, static_cast<uint64_t>(t * kOutputs), inc);
  int32_t c = 0;
  for (int64_t w = w0; w < w_end; w += 2) {
    s = add128(mul128(s, mult), inc);
    const uint64_t out = xsl_rr(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t word = h ? static_cast<uint32_t>(out >> 32) : static_cast<uint32_t>(out);
      const uint64_t m = static_cast<uint64_t>(word) * n;
      if (w + h < w_end && static_cast<uint32_t>(m) >= threshold) {
        if (COUNT) {
          ++c;
        } else {
          if (k < e) atomicAdd(&hist[m >> 32], 1);
          ++k;
        }
      }
    }
    if (!COUNT && k >= e) break;
  }
  if (COUNT) accepted[t] = c;
}

// out[i] = (the stream's i-th double < p), for i < n.
__global__ void __launch_bounds__(kThreads) bernoulli_kernel(U128 s0, U128 inc, int64_t n,
                                                            double p,
                                                            uint8_t* __restrict__ out) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kOutputs;
  if (i0 >= n) return;
  const int64_t i_end = min(n, i0 + kOutputs);
  const U128 mult{kMulHi, kMulLo};
  U128 s = advance(s0, static_cast<uint64_t>(i0), inc);
  for (int64_t i = i0; i < i_end; ++i) {
    s = add128(mul128(s, mult), inc);
    const double u = static_cast<double>(xsl_rr(s) >> 11) * (1.0 / 9007199254740992.0);
    out[i] = static_cast<uint8_t>(u < p);
  }
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The threads a stream of ``words`` words takes: the length of
// ``accepted`` and ``first``.
int64_t pcg64_indegree_threads(int64_t words) {
  return (words + 2 * kOutputs - 1) / (2 * kOutputs);
}

// count_pass 1: accepted[t] for every thread. count_pass 0: add the first
// ``e`` accepted ids into ``hist`` (int32, n entries, zeroed by the
// caller), given ``first``, the exclusive prefix sum of ``accepted``.
// Returns the launch's CUDA error.
int pcg64_indegree_pass(int count_pass, uint64_t s_hi, uint64_t s_lo, uint64_t inc_hi,
                        uint64_t inc_lo, uint32_t n, uint32_t threshold, int64_t words,
                        void* accepted, const void* first, int64_t e, void* hist,
                        void* stream) {
  const int64_t threads = pcg64_indegree_threads(words);
  if (threads <= 0) return 0;
  const unsigned blocks = blocks_for(threads);
  const U128 s0{s_hi, s_lo}, inc{inc_hi, inc_lo};
  auto st = static_cast<cudaStream_t>(stream);
  if (count_pass) {
    indegree_kernel<true><<<blocks, kThreads, 0, st>>>(
        s0, inc, n, threshold, words, static_cast<int32_t*>(accepted), nullptr, e, nullptr);
  } else {
    indegree_kernel<false><<<blocks, kThreads, 0, st>>>(
        s0, inc, n, threshold, words, nullptr, static_cast<const int64_t*>(first), e,
        static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// out (uint8, n entries) = the stream's first n doubles < p. Returns the
// launch's CUDA error.
int pcg64_bernoulli(uint64_t s_hi, uint64_t s_lo, uint64_t inc_hi, uint64_t inc_lo, int64_t n,
                    double p, void* out, void* stream) {
  if (n <= 0) return 0;
  bernoulli_kernel<<<blocks_for((n + kOutputs - 1) / kOutputs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      U128{s_hi, s_lo}, U128{inc_hi, inc_lo}, n, p, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
