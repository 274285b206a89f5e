// Fused infection step of the agent simulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel sbr_tpu/social/fused.py::_pallas_update. Per agent
// i, with id = id0 + i (uint32, wrapping):
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
// Only the frontier draws. An agent can change only if it is not informed
// and counts_i != 0. An informed agent is never newly informed. Where
// counts_i == 0, counts/deg is +0 or -0 (deg finite and nonzero, or
// infinite) or NaN (deg 0 or NaN); times -beta and dt it stays a zero or
// becomes NaN (beta or dt infinite or NaN); exp gives exactly 1 or NaN, and
// p = 1 - 1 = +0 or NaN. No u in [0, 1) is below +0 or NaN, so newly is
// false for every key. The half types round each operation (rt), and
// rt(+-0) = +-0, rt(1) = 1, rt(NaN) = NaN, so the same holds there. The
// kernel therefore skips the draw, the division and the exponential of every
// agent off the frontier and copies its informed byte (as 0 or 1) and its
// t_inf bits, which is what the full computation writes: every output bit is
// the same. The plain version (fused.py::_update_plain) computes every lane
// and so checks the skip; tests/test_torch_fused.py proves the rule on the
// CPU for all four types and the special values.
//
// What bounds it. The function needs informed (1 B) and t_inf in and
// informed' (1 B) and t_inf' out for every agent (10 B in float32, 18 B in
// float64, 6 B in the half types), the count (4 B) of an agent not
// informed, and beta and deg of a frontier agent. The kernel reads every
// agent's count, one int4 a lane: reading it only where a lane holds an
// agent not informed puts a load that waits for informed on every tile's
// path, and measured slower on every row but the all-informed ones
// (chip_smoke.py kernel main, PERF.md). A frontier agent also costs the
// 20-round Threefry, ~70 integer additions, funnel shifts and xors on the
// INT32 and IMAD pipes (64 lanes a clock on an SM each, half the float32
// rate), with the division and the exponential beside it: 115 (f32), 174
// (f64), 129 (half) instructions in the SASS of the loop that decides one
// agent, so on a wide frontier the issue slots (128 a clock on an SM) are
// the busiest pipe. chip_smoke.py prints each row's bound from its
// frontier and the counts it reads from the built library.
// - At DRAM sizes (10^7 agents, 100-380 MB) the bytes bound float32 and
//   float64: those rows run at the rate of the frontier-0 row, a plain
//   stream of 14 B an agent in float32 (2.8 TB/s on the H100). beta and
//   deg are read as one vector per lane that holds a frontier agent, which
//   touches the 32-byte sectors that reading the frontier agents alone
//   would touch; at a frontier of 0.6 that is almost every sector.
// - The half types move so few bytes that the instructions take as long:
//   there the issue of ~4 warp instructions a frontier agent and ~1.9 an
//   agent for the tile (loads, the scan, the list, the stores) does not
//   hide under the stream.
// - At the main path's 10^6 agents the working set (10-22 MB) stays in the
//   50 MB L2, and a launch is a few tiles a warp: launch and ramp time
//   weigh.
//
// What the design does about it:
// - Frontier compaction. A warp owns a tile of 32 x 4 agents. Each lane
//   loads its 4 agents' informed (one 4-byte word) and counts (one int4)
//   and marks its frontier agents; where it has one, it loads their beta
//   and deg (one vector each). A shuffle scan of the lanes' frontier counts
//   gives each lane its place in the warp's list in shared memory, where
//   it writes each frontier agent's tile offset, count, beta and deg. Then
//   the 32 lanes draw and decide the listed agents only, two list entries
//   a lane at a time (their Threefry rounds interleaved: two independent
//   chains to issue from), then a lane's last entry alone; each decision
//   goes to a byte of the tile in shared memory, and each lane writes its
//   own 4 agents' outputs.
// - Coalesced vector access. A lane's 4 agents are consecutive and the 32
//   lanes' chunks are too, so each stream moves as one coalesced access of
//   the warp: 4 bytes a lane of informed, 16 of counts and float32 t_inf, 8
//   of half t_inf, two of 16 of float64 t_inf. (16 agents a lane, with
//   16-byte accesses of informed and four int4 of counts, measured slower:
//   each int4 and t_inf access of the warp then touches 32 lines half.)
//   A pointer that is not 16-byte aligned (a view such as the sharded
//   gather's counts slice) and the ragged tail take a scalar path, element
//   by element; the arithmetic is the same.
// - A persistent grid: as many blocks as fit on the card at once (the SM
//   count times the occupancy, read once a device), or fewer for a small
//   n. Each warp walks over tiles with the next tile's informed, counts
//   and t_inf in flight while it decides the current one.
// One pass, each input read once, each output written once; no
// allocation, one launch a step on the caller's stream.
//
// Rounding: compiled with -fmad=false and the accurate exp/expf, in the
// operation order of sbr_tpu's _update_lax, so the kernel and the plain
// PyTorch version agree bit for bit on the same card.
//
// float16 and bfloat16: PyTorch computes each operation on a half type in
// float32 and rounds the result to the type, and so does XLA on the CPU for
// this chain. The kernel does the same, one rounding (rt) after every
// operation, with dt already a value of the type; the uniform is the
// float32 draw rounded to the type and clamped below 1.0.

#include <cstdint>
#include <cstring>
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

// Two blocks of the same key on counters (a, 0) and (b, 0), their rounds
// interleaved: two independent chains for the scheduler to issue from.
__device__ __forceinline__ void threefry2x32_pair(uint32_t k0, uint32_t k1, uint32_t a,
                                                  uint32_t b, uint32_t& a0, uint32_t& a1,
                                                  uint32_t& b0, uint32_t& b1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  uint32_t x0 = a + ks[0], x1 = ks[1];
  uint32_t y0 = b + ks[0], y1 = ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if ((i & 1) == 0) {
      mix(x0, x1, 13); mix(y0, y1, 13); mix(x0, x1, 15); mix(y0, y1, 15);
      mix(x0, x1, 26); mix(y0, y1, 26); mix(x0, x1, 6); mix(y0, y1, 6);
    } else {
      mix(x0, x1, 17); mix(y0, y1, 17); mix(x0, x1, 29); mix(y0, y1, 29);
      mix(x0, x1, 16); mix(y0, y1, 16); mix(x0, x1, 24); mix(y0, y1, 24);
    }
    x0 += ks[(i + 1) % 3];
    y0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    y1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  a0 = x0; a1 = x1; b0 = y0; b1 = y1;
}

__device__ __forceinline__ float uniform_f32(uint32_t x0) {
  return __uint_as_float((x0 >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double uniform_f64(uint32_t x0, uint32_t x1) {
  const uint64_t bits = (((static_cast<uint64_t>(x0) << 32) | x1) >> 12) |
                        0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
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

// Per type: the bits t_inf, beta and deg move as, the type a frontier
// agent's beta and deg wait in (the type itself, or float32 for the half
// types: the conversion is exact), the type dt comes in, and the decision
// of one frontier agent (the accurate exponentials, never __expf).
template <typename T>
struct Step;

template <>
struct Step<float> {
  using Bits = unsigned int;
  using Op = float;
  using Dt = float;
  static __device__ __forceinline__ Op operand(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ bool newly(uint32_t x0, uint32_t, int32_t c, float beta,
                                               float deg, float dt) {
    const float u = uniform_f32(x0);
    const float frac = static_cast<float>(c) / deg;
    const float p = 1.0f - expf(((-beta) * frac) * dt);
    return u < p;
  }
};

template <>
struct Step<double> {
  using Bits = unsigned long long;
  using Op = double;
  using Dt = double;
  static __device__ __forceinline__ Op operand(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ __forceinline__ bool newly(uint32_t x0, uint32_t x1, int32_t c,
                                               double beta, double deg, double dt) {
    const double u = uniform_f64(x0, x1);
    const double frac = static_cast<double>(c) / deg;
    const double p = 1.0 - exp(((-beta) * frac) * dt);
    return u < p;
  }
};

__device__ __forceinline__ float half_bits_to_f32(unsigned short b, __half*) {
  return __half2float(__ushort_as_half(b));
}
__device__ __forceinline__ float half_bits_to_f32(unsigned short b, __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

template <typename H>
struct HalfStep {
  using Bits = unsigned short;
  using Op = float;
  using Dt = float;
  static __device__ __forceinline__ Op operand(Bits b) {
    return half_bits_to_f32(b, static_cast<H*>(nullptr));
  }
  static __device__ __forceinline__ bool newly(uint32_t x0, uint32_t, int32_t c, float beta,
                                               float deg, float dt) {
    const float u = fminf(rt<H>(uniform_f32(x0)), below_one<H>());
    const float frac = rt<H>(rt<H>(static_cast<float>(c)) / deg);
    const float rate = rt<H>(rt<H>(-beta * frac) * dt);
    const float p = rt<H>(1.0f - rt<H>(expf(rate)));
    return u < p;
  }
};
template <>
struct Step<__half> : HalfStep<__half> {};
template <>
struct Step<__nv_bfloat16> : HalfStep<__nv_bfloat16> {};

constexpr int kWarps = 8;                // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 4;                  // agents a lane owns in a tile
constexpr int kTile = 32 * kPer;         // agents a warp's tile
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 0x01 in each byte of w that is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) >> 7 & 0x01010101u;
}

// A lane's four values of one stream of 2-, 4- or 8-byte elements, as
// 32-bit words. Every index is a constant once the loops unroll, so the
// words stay in registers.
template <typename Bits>
struct Words {
  static constexpr int kN = kPer * static_cast<int>(sizeof(Bits)) / 4;
  uint32_t w[kN];

  __device__ __forceinline__ Bits get(int j) const {
    if constexpr (sizeof(Bits) == 2) {
      return static_cast<Bits>(w[j >> 1] >> (16 * (j & 1)));
    } else if constexpr (sizeof(Bits) == 4) {
      return w[j];
    } else {
      return static_cast<Bits>(w[2 * j]) | (static_cast<Bits>(w[2 * j + 1]) << 32);
    }
  }
  __device__ __forceinline__ void set(int j, Bits v) {
    if constexpr (sizeof(Bits) == 2) {
      const int s = 16 * (j & 1);
      w[j >> 1] = (w[j >> 1] & ~(0xFFFFu << s)) | (static_cast<uint32_t>(v) << s);
    } else if constexpr (sizeof(Bits) == 4) {
      w[j] = v;
    } else {
      w[2 * j] = static_cast<uint32_t>(v);
      w[2 * j + 1] = static_cast<uint32_t>(v >> 32);
    }
  }
  // elements [a, a + m) of p: one coalesced vector (8 bytes for the half
  // types, 16 for float32, two of 16 for float64) where all four lie below
  // n and the pointers are aligned, else element by element
  __device__ __forceinline__ void load(const Bits* p, int64_t a, int m, bool vec) {
    if (m == kPer && vec) {
      if constexpr (sizeof(Bits) == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + a));
        w[0] = v.x; w[1] = v.y;
      } else {
#pragma unroll
        for (int k = 0; k < kN / 4; ++k) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + a) + k);
          w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) w[k] = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < m) set(j, __ldg(p + a + j));
      }
    }
  }
  __device__ __forceinline__ void store(Bits* p, int64_t a, int m, bool vec) const {
    if (m == kPer && vec) {
      if constexpr (sizeof(Bits) == 2) {
        *reinterpret_cast<uint2*>(p + a) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int k = 0; k < kN / 4; ++k) {
          reinterpret_cast<uint4*>(p + a)[k] =
              make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < m) p[a + j] = get(j);
      }
    }
  }
};

// One lane's agents of a tile in the streams every agent reads: informed (a
// byte each, one 4-byte word), counts (one int4), t_inf; and how many of the
// four lie below n. An agent past n reads as informed.
template <typename Bits>
struct Chunk {
  uint32_t inf;
  int32_t cnt[kPer];
  Words<Bits> t;
  int m;

  __device__ __forceinline__ void load(const uint8_t* informed, const Bits* t_inf,
                                       const int32_t* counts, int64_t a, int64_t n,
                                       bool vec) {
    const int64_t left = n - a;
    m = left >= kPer ? kPer : (left > 0 ? static_cast<int>(left) : 0);
    if (m == kPer && vec) {
      inf = __ldg(reinterpret_cast<const unsigned int*>(informed + a));
      const int4 c = __ldg(reinterpret_cast<const int4*>(counts + a));
      cnt[0] = c.x; cnt[1] = c.y; cnt[2] = c.z; cnt[3] = c.w;
    } else {
      inf = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool in = j < m;
        inf |= static_cast<uint32_t>(in ? __ldg(informed + a + j) : 1) << (8 * j);
        cnt[j] = in ? __ldg(counts + a + j) : 0;
      }
    }
    t.load(t_inf, a, m, vec);
  }
};

// What a warp keeps in shared memory for its tile: the frontier's offsets
// in order, their counts, beta and deg, and a decision byte an agent.
template <typename T>
struct TileShared {
  using Op = typename Step<T>::Op;
  Op beta[kTile];
  Op deg[kTile];
  int32_t cnt[kTile];
  uint32_t decided[32];
  uint8_t list[kTile];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) infection_update_kernel(
    const uint8_t* __restrict__ informed, const typename Step<T>::Bits* __restrict__ t_inf,
    const int32_t* __restrict__ counts, const typename Step<T>::Bits* __restrict__ betas,
    const typename Step<T>::Bits* __restrict__ safe_deg, uint8_t* __restrict__ informed_out,
    typename Step<T>::Bits* __restrict__ t_inf_out, int64_t n, uint32_t id0,
    uint32_t k0, uint32_t k1, typename Step<T>::Bits t_next, typename Step<T>::Dt dt) {
  using Bits = typename Step<T>::Bits;
  __shared__ TileShared<T> shared[kWarps];

  const int lane = threadIdx.x & 31;
  TileShared<T>& sh = shared[threadIdx.x >> 5];
  uint8_t* decided = reinterpret_cast<uint8_t*>(sh.decided);
  // the streams move in vectors only where every pointer is aligned (a
  // view, such as the sharded gather's counts slice, may not be)
  const bool vec = aligned16(informed) && aligned16(informed_out) && aligned16(counts) &&
                   aligned16(t_inf) && aligned16(t_inf_out) && aligned16(betas) &&
                   aligned16(safe_deg);
  const int own = lane * kPer;  // this lane's first agent in a tile

  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  Chunk<Bits> cur;
  if (tile < n_tiles) cur.load(informed, t_inf, counts, tile * kTile + own, n, vec);
  for (; tile < n_tiles; tile += stride) {
    const int64_t a = tile * kTile + own;
    // the next tile's loads fly while this one is decided
    Chunk<Bits> nxt;
    if (tile + stride < n_tiles) nxt.load(informed, t_inf, counts, a + stride * kTile, n, vec);

    // 1. the frontier (not informed, counts != 0) and its beta and deg,
    //    read only where this lane has a frontier agent
    uint32_t front = nonzero_bytes(cur.inf) ^ 0x01010101u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (cur.cnt[j] == 0) front &= ~(1u << (8 * j));
    }
    Words<Bits> beta, deg;
    if (front != 0) {
      beta.load(betas, a, cur.m, vec);
      deg.load(safe_deg, a, cur.m, vec);
    }

    // 2. the warp's frontier list, in order: each lane's agents at its
    //    place (a shuffle scan), with their operands
    const int c = __popc(front);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int pos = incl - c;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((front >> (8 * j)) & 1u) {
        sh.list[pos] = static_cast<uint8_t>(own + j);
        sh.cnt[pos] = cur.cnt[j];
        sh.beta[pos] = Step<T>::operand(beta.get(j));
        sh.deg[pos] = Step<T>::operand(deg.get(j));
        ++pos;
      }
    }
    __syncwarp();

    // 3. draw and decide the listed agents only: entries e and e + 32 of
    //    the list together while both exist (two chains to interleave),
    //    then a lane's last entry alone
    const int64_t base = tile * kTile;
    int e = lane;
#pragma unroll 1
    for (; e + 32 < total; e += 64) {
      const int oa = sh.list[e];
      const int ob = sh.list[e + 32];
      uint32_t a0, a1, b0, b1;
      threefry2x32_pair(k0, k1, id0 + static_cast<uint32_t>(base + oa),
                        id0 + static_cast<uint32_t>(base + ob), a0, a1, b0, b1);
      decided[oa] = Step<T>::newly(a0, a1, sh.cnt[e], sh.beta[e], sh.deg[e], dt);
      decided[ob] = Step<T>::newly(b0, b1, sh.cnt[e + 32], sh.beta[e + 32], sh.deg[e + 32],
                                   dt);
    }
#pragma unroll 1
    for (; e < total; e += 32) {
      const int off = sh.list[e];
      uint32_t x0, x1;
      threefry2x32(k0, k1, id0 + static_cast<uint32_t>(base + off), 0u, x0, x1);
      decided[off] = Step<T>::newly(x0, x1, sh.cnt[e], sh.beta[e], sh.deg[e], dt);
    }
    __syncwarp();

    // 4. this lane's outputs: informed' as 0 or 1, t_inf' = t_next where newly
    const uint32_t nw = sh.decided[lane] & front;
    const uint32_t out = nonzero_bytes(cur.inf) | nw;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((nw >> (8 * j)) & 1u) cur.t.set(j, t_next);
    }
    if (cur.m == kPer && vec) {
      *reinterpret_cast<unsigned int*>(informed_out + a) = out;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < cur.m) informed_out[a + j] = static_cast<uint8_t>(out >> (8 * j));
      }
    }
    cur.t.store(t_inf_out, a, cur.m, vec);
    __syncwarp();  // the next tile's list and decisions overwrite these
    cur = nxt;
  }
}

constexpr int kMaxDevices = 64;

// Blocks of the persistent grid on the current device: its SM count times
// the blocks of infection_update_kernel<T> that fit on one SM, read once.
template <typename T>
int resident_blocks(int* blocks) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, infection_update_kernel<T>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

template <typename T>
int launch(const void* informed, const void* t_inf, const void* counts,
           const void* betas, const void* safe_deg, void* informed_out,
           void* t_inf_out, int64_t n, uint32_t id0, uint32_t k0, uint32_t k1,
           typename Step<T>::Bits t_next, typename Step<T>::Dt dt, void* stream) {
  using Bits = typename Step<T>::Bits;
  if (n <= 0) return 0;
  int resident = 0;
  const int rc = resident_blocks<T>(&resident);
  if (rc != 0) return rc;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t wanted = (tiles + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(wanted < resident ? wanted : resident);
  infection_update_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(informed), static_cast<const Bits*>(t_inf),
      static_cast<const int32_t*>(counts), static_cast<const Bits*>(betas),
      static_cast<const Bits*>(safe_deg), static_cast<uint8_t*>(informed_out),
      static_cast<Bits*>(t_inf_out), n, id0, k0, k1, t_next, dt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
typename Step<T>::Bits host_bits(double x);
template <>
Step<float>::Bits host_bits<float>(double x) {
  const float v = static_cast<float>(x);
  Step<float>::Bits b;
  memcpy(&b, &v, sizeof(b));
  return b;
}
template <>
Step<double>::Bits host_bits<double>(double x) {
  Step<double>::Bits b;
  memcpy(&b, &x, sizeof(b));
  return b;
}
// t_next is a value of H (the caller rounds it), so the conversion is exact
template <>
Step<__half>::Bits host_bits<__half>(double x) {
  const __half v = from_f32<__half>(static_cast<float>(x));
  Step<__half>::Bits b;
  memcpy(&b, &v, sizeof(b));
  return b;
}
template <>
Step<__nv_bfloat16>::Bits host_bits<__nv_bfloat16>(double x) {
  const __nv_bfloat16 v = from_f32<__nv_bfloat16>(static_cast<float>(x));
  Step<__nv_bfloat16>::Bits b;
  memcpy(&b, &v, sizeof(b));
  return b;
}

template <typename T>
int launch_typed(const void* informed, const void* t_inf, const void* counts,
                 const void* betas, const void* safe_deg, void* informed_out,
                 void* t_inf_out, int64_t n, uint32_t id0, uint32_t k0, uint32_t k1,
                 double t_next, double dt, void* stream) {
  // dt is a value of the type (the caller rounds it), so this is exact too
  return launch<T>(informed, t_inf, counts, betas, safe_deg, informed_out, t_inf_out, n,
                   id0, k0, k1, host_bits<T>(t_next),
                   static_cast<typename Step<T>::Dt>(dt), stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or the error
// of the device query that sizes the grid.
int sbr_infection_update_f32(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch_typed<float>(informed, t_inf, counts, betas, safe_deg, informed_out,
                             t_inf_out, n, id0, k0, k1, t_next, dt, stream);
}

int sbr_infection_update_f64(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch_typed<double>(informed, t_inf, counts, betas, safe_deg, informed_out,
                              t_inf_out, n, id0, k0, k1, t_next, dt, stream);
}

int sbr_infection_update_f16(const void* informed, const void* t_inf,
                             const void* counts, const void* betas,
                             const void* safe_deg, void* informed_out,
                             void* t_inf_out, int64_t n, uint32_t id0,
                             uint32_t k0, uint32_t k1, double t_next, double dt,
                             void* stream) {
  return launch_typed<__half>(informed, t_inf, counts, betas, safe_deg, informed_out,
                              t_inf_out, n, id0, k0, k1, t_next, dt, stream);
}

int sbr_infection_update_bf16(const void* informed, const void* t_inf,
                              const void* counts, const void* betas,
                              const void* safe_deg, void* informed_out,
                              void* t_inf_out, int64_t n, uint32_t id0,
                              uint32_t k0, uint32_t k1, double t_next, double dt,
                              void* stream) {
  return launch_typed<__nv_bfloat16>(informed, t_inf, counts, betas, safe_deg,
                                     informed_out, t_inf_out, n, id0, k0, k1, t_next,
                                     dt, stream);
}

}  // extern "C"
