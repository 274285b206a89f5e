// Recount bit-gather of the agent simulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// benchmarks/ablate_pallas_recount.py::_build_pallas_gather. Per edge e,
// with s = src[e] the edge's source agent:
//
//   packed:    active[e] = (mask[s >> 3] >> (s & 7)) & 1
//   unpacked:  active[e] = mask[s]
//
// written as int32. The mask is the withdrawn set of the recount, packed
// little-endian eight agents a byte (np.packbits(wd, bitorder="little")) or
// one byte an agent. Ids must lie in [0, N): an id outside the mask's bits
// reads 0 here (the guard keeps every read inside the mask), which no
// caller may rely on.
//
// What bounds it: memory traffic. Each edge reads its 4-byte id and writes
// its 4-byte result, and the mask is read once: at the production shape
// (10^6 agents, 10,092,544 edges) that is 80.7 MB, 24.1 us packed and
// 24.4 us unpacked at 3.35 TB/s. Keeping HBM busy takes megabytes of loads
// in flight across the card, and each lookup is a random byte, so where the
// mask sits decides what a lookup costs: shared memory is cheap, L1 cheap
// where the mask fits it, L2 (a 32-byte sector a byte) and distributed
// shared memory (lookups over it measured slower than L2: PERF.md §6) are
// not.
//
// What the design does about it. sbr_tpu_torch/social/recount.py::
// plan_launch makes the launch plan once a shape; the size rule and the
// measured times on an H100 are in PERF.md §6.
//
// - The id stream. A persistent grid, as many blocks as are resident, of
//   1,024 threads: every thread keeps 4 loads of 16 bytes in flight
//   (L1::no_allocate, so L1 keeps the mask), looks up 4 bits a load and
//   writes 4 results as one 16-byte streaming store. The output shares the
//   ids' alignment modulo 16 (the wrapper's doing), so one offset of 0-3
//   edges aligns both; the edges before it and after the last quad go by
//   threads.
// - Where the mask sits (the branch):
//   * "shared": a bit table in every block's shared memory: a packed
//     mask's bytes, or an unpacked mask packed here eight agents a byte
//     (a byte other than 0 or 1 anywhere sends every lookup to the mask, so
//     any input reads as the plain version does). A block holds the whole
//     table where it fits, else its first part ("split"), and the rest of
//     the lookups read the mask through L1. A cluster of 1-4 blocks stages
//     it together: each stages a chunk (packed: one bulk copy on its own
//     mbarrier, the unaligned bytes around it by hand; unpacked: 16 mask
//     bytes a thread, 4 loads in flight), then copies the others' chunks
//     through distributed shared memory. The table is waited for only
//     after each thread's first ids are on their way, so staging and the
//     first id loads overlap.
//   * "global": every lookup through the read-only path, with the SM's
//     memory given to L1.
// - Set-up. Before its first launch a kernel's shared-memory limit and L1
//   carveout are set once (sbr_recount_allow_smem) and the blocks the card
//   holds at once counted once a launch shape (sbr_recount_resident); the
//   launches themselves only launch (cudaLaunchKernelEx, a cluster's
//   dimension as a launch attribute). Each entry point works on the device
//   it is given and leaves the caller's current device as it found it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Dynamic shared memory: two mbarriers and a flag, then the bit table.
constexpr int kTableOffset = 128;

struct Args {
  const uint8_t* mask;
  int64_t n_mask;
  const int32_t* src;
  int32_t* out;
  int64_t n_edges;
  int held;  // shared: bytes of the bit table a block holds (agents [0, 8 * held))
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// 16 bytes at `local` in the shared memory of block `rank` of this cluster.
__device__ __forceinline__ uint4 cluster_vec(uint32_t local, uint32_t rank) {
  uint32_t remote;
  uint4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote));
  return v;
}

__device__ __forceinline__ uint32_t cluster_word(uint32_t local, uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// By one thread: table[t] = src0[t - pad] for t in [max(lo, pad), hi), the
// 16-byte-aligned body by one bulk copy that completes on `bar` (this
// thread's arrival), the bytes around it by hand. src0 - pad is 16-byte
// aligned.
__device__ void stage_copy(uint8_t* table, const uint8_t* src0, uint32_t pad, int64_t lo,
                           int64_t hi, uint32_t bar) {
  const int64_t first = lo > pad ? lo : pad;
  int64_t body_lo = (first + 15) / 16 * 16;
  if (body_lo > hi) body_lo = hi;
  const int64_t body_hi = body_lo + (hi - body_lo) / 16 * 16;
  for (int64_t t = first; t < body_lo; ++t) table[t] = src0[t - pad];
  for (int64_t t = body_hi; t < hi; ++t) table[t] = src0[t - pad];
  const uint32_t bytes = static_cast<uint32_t>(body_hi - body_lo);
  mbar_expect_tx(bar, bytes);
  if (bytes) bulk_load(smem_u32(table + body_lo), src0 + (body_lo - pad), bytes, bar);
}

// volatile keeps these loads after the waits that stage the tables; with
// no memory clobber, the code around them still moves freely.
__device__ __forceinline__ uint32_t shared_byte(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// 16 bytes of ids, kept out of L1 (which then holds more of the mask);
// volatile keeps the first of them ahead of the wait for the mask.
__device__ __forceinline__ int4 load_ids(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <bool kPacked, bool kShared>
struct Lookup {
  uint32_t limit;        // agents; ids at or above it (negative ones too) read 0
  uint32_t held;         // shared: agents [0, held) are in the bit table
  const uint8_t* mask;
  uint32_t table_u32;    // shared: the bit table's byte 0

  __device__ __forceinline__ int32_t operator()(int32_t s) const {
    const uint32_t u = static_cast<uint32_t>(s);
    if (kShared && u < held)
      return static_cast<int32_t>((shared_byte(table_u32 + (u >> 3)) >> (u & 7)) & 1);
    if (u >= limit) return 0;
    if (kPacked) return static_cast<int32_t>((__ldg(mask + (u >> 3)) >> (u & 7)) & 1);
    return static_cast<int32_t>(__ldg(mask + u));
  }

  __device__ __forceinline__ int4 operator()(int4 s) const {
    return make_int4((*this)(s.x), (*this)(s.y), (*this)(s.z), (*this)(s.w));
  }
};

template <bool kPacked, bool kShared>
__global__ void __launch_bounds__(1024, 1) recount_gather_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  uint64_t* stage_bar = reinterpret_cast<uint64_t*>(smem);  // this block's part is in
  uint64_t* table_bar = stage_bar + 1;                       // the peers' parts are in
  uint32_t* odd = reinterpret_cast<uint32_t*>(stage_bar + 2);  // an unpacked byte > 1
  const uint32_t blocks = kShared ? cluster_blocks() : 1;
  const uint32_t rank = blocks > 1 ? cluster_rank() : 0;

  if (kShared) {
    if (tid == 0) {
      mbar_init(smem_u32(stage_bar), nthreads);
      mbar_init(smem_u32(table_bar), nthreads);
      *odd = 0;
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // Edges [head, head + 4 * n_quads) are 16-byte aligned in both the ids
  // and the output; the head and tail around them go by threads.
  const int64_t n = a.n_edges;
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(a.src) & 15)) & 15) / 4;
  if (head > n) head = n;
  const int64_t n_quads = (n - head) / 4;
  const int64_t tail = head + 4 * n_quads;
  const int4* src4 = reinterpret_cast<const int4*>(a.src + head);
  int4* out4 = reinterpret_cast<int4*>(a.out + head);

  // This block's part of the table. Table byte t is, packed, mask byte
  // t - pad (pad the mask pointer's offset modulo 16, which aligns the
  // mask's body) and, unpacked, the bits of agents 8t..8t+7, packed here.
  // A cluster's blocks each stage a chunk of `chunk` bytes and then copy
  // the others' chunks from them.
  uint8_t* table = smem + kTableOffset;
  const uint32_t pad =
      kPacked ? static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a.mask) & 15) : 0;
  Lookup<kPacked, kShared> look;
  const uint64_t agents = kPacked ? static_cast<uint64_t>(a.n_mask) * 8 : a.n_mask;
  look.limit = agents < (uint64_t{1} << 31) ? static_cast<uint32_t>(agents) : (1u << 31);
  const uint64_t held = static_cast<uint64_t>(a.held) * 8;
  look.held = held < look.limit ? static_cast<uint32_t>(held) : look.limit;
  look.mask = a.mask;
  look.table_u32 = smem_u32(table + pad);
  const int64_t span = pad + a.held;  // table bytes in use
  const int64_t chunk = ((span + blocks - 1) / blocks + 15) / 16 * 16;
  if constexpr (kShared) {
    const int64_t lo = rank * chunk < span ? rank * chunk : span;
    const int64_t hi = lo + chunk < span ? lo + chunk : span;
    if constexpr (kPacked) {
      if (tid == 0) stage_copy(table, a.mask, pad, lo, hi, smem_u32(stage_bar));
      else mbar_arrive(smem_u32(stage_bar));
    } else {
      // 16 mask bytes (two table bytes) a thread at a time, four in flight,
      // where the mask is 16-byte aligned; byte by byte where not
      uint32_t seen_odd = 0;
      const int64_t whole = look.held / 16 * 2 < hi ? look.held / 16 * 2 : hi;  // in table bytes
      int64_t t0 = lo;
      if ((reinterpret_cast<uintptr_t>(a.mask) & 15) == 0) {
        const uint4* m16 = reinterpret_cast<const uint4*>(a.mask);
        const int64_t units = whole > lo ? (whole - lo) / 2 : 0;
        for (int64_t u0 = tid; u0 < units; u0 += 4 * nthreads) {
          uint4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (u0 + j * nthreads < units) v[j] = __ldg(m16 + lo / 2 + u0 + j * nthreads);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (u0 + j * nthreads < units) {
              const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
              uint32_t bits = 0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                // one bit a nonzero byte, little-endian: (b0 + 2 b1 + 4 b2 + 8 b3) << 4i
                const uint32_t nz = __vcmpne4(w[i], 0) & 0x01010101u;
                bits |= ((nz * 0x01020408u) >> 24) << (4 * i);
                seen_odd |= __vcmpgtu4(w[i], 0x01010101u);
              }
              const int64_t t = lo + 2 * (u0 + j * nthreads);
              table[t] = static_cast<uint8_t>(bits);
              table[t + 1] = static_cast<uint8_t>(bits >> 8);
            }
          }
        }
        t0 = lo + 2 * units;
      }
      for (int64_t t = t0 + tid; t < hi; t += nthreads) {
        uint32_t bits = 0;
        for (int k = 0; k < 8; ++k) {
          const int64_t i = 8 * t + k;
          if (i < look.held) {
            const uint32_t b = __ldg(a.mask + i);
            bits |= (b != 0) << k;
            seen_odd |= b > 1;
          }
        }
        table[t] = static_cast<uint8_t>(bits);
      }
      if (seen_odd) atomicOr(odd, 1u);
      mbar_arrive(smem_u32(stage_bar));
    }
  }

  // Waited for by every thread once, before its first lookup (after its
  // first ids are on their way): this block's part staged and, in a
  // cluster, every block's, with the peers' chunks copied in.
  bool ready = !kShared;
  auto wait_for_table = [&]() {
    if (ready) return;
    ready = true;
    mbar_wait(smem_u32(stage_bar), 0);
    if constexpr (!kPacked) {
      if (*odd) look.held = 0;  // bytes other than 0 and 1 are read as they are
    }
    if (blocks < 2) return;
    cluster_arrive();
    cluster_wait();
    const int64_t used = (span + 15) / 16 * 16;
    const uint32_t base = smem_u32(table);
    for (uint32_t p = 0; p < blocks; ++p) {
      if (p == rank) continue;
      const int64_t lo = p * chunk;
      const int64_t hi = lo + chunk < used ? lo + chunk : used;
      for (int64_t i0 = lo + 16 * tid; i0 < hi; i0 += 64 * nthreads) {
        uint4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t i = i0 + 16 * j * nthreads;
          if (i < hi) v[j] = cluster_vec(base + static_cast<uint32_t>(i), p);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t i = i0 + 16 * j * nthreads;
          if (i < hi) *reinterpret_cast<uint4*>(table + i) = v[j];
        }
      }
      if constexpr (!kPacked) {
        if (cluster_word(smem_u32(odd), p)) look.held = 0;
      }
    }
    mbar_arrive(smem_u32(table_bar));
    cluster_arrive();  // done reading the peers; waited for before exit
    mbar_wait(smem_u32(table_bar), 0);
  };

  const int64_t stride = static_cast<int64_t>(gridDim.x) * nthreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * nthreads + tid; q < n_quads;
       q += 4 * stride) {
    int4 s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u * stride < n_quads) s[u] = load_ids(src4 + q + u * stride);
    }
    wait_for_table();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u * stride < n_quads) __stcs(out4 + q + u * stride, look(s[u]));
    }
  }
  wait_for_table();
  if (blockIdx.x == 0) {
    if (tid < head) a.out[tid] = look(__ldg(a.src + tid));
    if (tid < n - tail) a.out[tail + tid] = look(__ldg(a.src + tail + tid));
  }

  // no block leaves while the others may still read its part
  if (kShared && blocks > 1) cluster_wait();
}

using KernelFn = void (*)(Args);

// kernel id = 2 * packed + global
const KernelFn kKernels[4] = {
    recount_gather_kernel<false, true>,
    recount_gather_kernel<false, false>,
    recount_gather_kernel<true, true>,
    recount_gather_kernel<true, false>,
};

bool valid_kernel(int kernel_id) { return kernel_id >= 0 && kernel_id < 4; }

void fill_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid, int threads,
                 int smem, int cluster, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg->blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  if (cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = static_cast<unsigned>(cluster);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
}

// Makes `device` the current device for its scope; the caller's comes back
// at its end.
class OnDevice {
 public:
  explicit OnDevice(int device) {
    err_ = cudaGetDevice(&before_);
    if (err_ == cudaSuccess && before_ != device) err_ = cudaSetDevice(device);
    else before_ = -1;
  }
  ~OnDevice() {
    if (before_ >= 0) cudaSetDevice(before_);
  }
  cudaError_t error() const { return err_; }

 private:
  int before_ = -1;
  cudaError_t err_;
};

}  // namespace

extern "C" {

// The card's numbers the plan needs: streaming multiprocessors, the
// shared memory a block may opt in to, the shared memory of one SM.
int sbr_recount_limits(int device, int* sms, int* smem_optin, int* smem_per_sm) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 device);
  return static_cast<int>(err);
}

// Once per kernel and device: lets kernel `kernel_id` take up to
// `smem_optin` bytes of dynamic shared memory on `device`.
int sbr_recount_allow_smem(int device, int kernel_id, int smem_optin) {
  if (!valid_kernel(kernel_id)) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  cudaError_t err = on.error();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kKernels[kernel_id], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_optin);
  // the global branch leaves the SM's memory to L1, which caches the mask
  if (err == cudaSuccess && kernel_id % 2 == 1)
    err = cudaFuncSetAttribute(kKernels[kernel_id],
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxL1);
  return static_cast<int>(err);
}

// Once per launch shape, after sbr_recount_allow_smem: the blocks of
// kernel `kernel_id` that `device` holds at once with `threads`, `smem`
// and `cluster` (in whole clusters).
int sbr_recount_resident(int device, int kernel_id, int threads, int smem, int cluster,
                         int* resident) {
  *resident = 0;
  if (!valid_kernel(kernel_id)) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  cudaError_t err = on.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const KernelFn fn = kKernels[kernel_id];
  if (cluster > 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    fill_config(&cfg, &attr, cluster, threads, smem, cluster, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    *resident = clusters * cluster;
  } else {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                          static_cast<size_t>(smem));
    *resident = per_sm * sms;
  }
  return static_cast<int>(err);
}

// Launches kernel `kernel_id` on `stream` of `device` with the plan's
// numbers and returns cudaGetLastError() (0 on success). The output must
// share the ids' alignment modulo 16.
int sbr_recount_launch(int device, int kernel_id, const void* mask, int64_t n_mask,
                       const void* src, void* out, int64_t n_edges, int grid, int threads,
                       int smem, int cluster, int held, void* stream) {
  const auto s = reinterpret_cast<uintptr_t>(src);
  const auto o = reinterpret_cast<uintptr_t>(out);
  if (!valid_kernel(kernel_id) || s % 4 || o % 4 || (s - o) % 16 || grid < 1 ||
      (cluster > 1 && grid % cluster) || smem < kTableOffset)
    return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  Args a;
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_mask = n_mask;
  a.src = static_cast<const int32_t*>(src);
  a.out = static_cast<int32_t*>(out);
  a.n_edges = n_edges;
  a.held = held;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(&cfg, &attr, grid, threads, smem, cluster, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernels[kernel_id], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
