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
// 24.4 us unpacked at 3.35 TB/s. The reads of the mask are random, one
// byte an edge, so the cost beyond the bound is the latency of those
// reads.
//
// What the design does about it. The TPU kernel's idea is a mask resident
// in fast memory while the ids stream past. Here:
//
// - Where the mask fits in a block's dynamic shared memory (227 KB on an
//   H100; the packed mask of 10^6 agents is 125,000 B), each block copies
//   it there once, 16 bytes a thread when the pointer is aligned, and then
//   walks a grid-stride range of edges reading bits from shared memory.
//   The grid is one block per streaming multiprocessor times the blocks
//   that fit, so the mask is copied a few hundred times from L2, not once
//   per edge block.
// - Where it does not fit, the same kernel reads the mask through the
//   read-only path (__ldg); a mask of a few MB stays in the 50 MB L2.
//
// The ids are read and the results written in order, coalesced, one edge a
// thread per step of the grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kPacked, bool kShared>
__global__ void recount_gather_kernel(const uint8_t* __restrict__ mask,
                                      int64_t n_mask,
                                      const int32_t* __restrict__ src,
                                      int32_t* __restrict__ out,
                                      int64_t n_edges) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* table = mask;
  if (kShared) {
    const int64_t n_vec =
        (reinterpret_cast<uintptr_t>(mask) % 16 == 0) ? n_mask / 16 : 0;
    const uint4* mask4 = reinterpret_cast<const uint4*>(mask);
    uint4* smem4 = reinterpret_cast<uint4*>(smem);
    for (int64_t i = threadIdx.x; i < n_vec; i += blockDim.x) {
      smem4[i] = __ldg(&mask4[i]);
    }
    for (int64_t i = n_vec * 16 + threadIdx.x; i < n_mask; i += blockDim.x) {
      smem[i] = __ldg(&mask[i]);
    }
    __syncthreads();
    table = smem;
  }
  const uint64_t limit =
      kPacked ? static_cast<uint64_t>(n_mask) * 8 : static_cast<uint64_t>(n_mask);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_edges; e += stride) {
    const int32_t s = __ldg(&src[e]);
    int32_t v = 0;
    if (s >= 0 && static_cast<uint64_t>(s) < limit) {
      const int64_t at = kPacked ? (s >> 3) : s;
      const uint8_t byte = kShared ? table[at] : __ldg(&table[at]);
      v = kPacked ? (byte >> (s & 7)) & 1 : static_cast<int32_t>(byte);
    }
    out[e] = v;
  }
}

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <bool kPacked>
int launch(const void* mask, int64_t n_mask, const void* src, void* out,
           int64_t n_edges, void* stream, int* branch) {
  *branch = -1;
  if (n_edges <= 0) return 0;
  int device = 0;
  int sms = 0;
  int smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* s = static_cast<const int32_t*>(src);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_mask <= smem_optin) {
    // round up so that the 16-byte staging never writes past the buffer
    const size_t bytes = static_cast<size_t>((n_mask + 15) / 16 * 16);
    err = cudaFuncSetAttribute(recount_gather_kernel<kPacked, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, recount_gather_kernel<kPacked, true>, kSharedThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    int64_t blocks = (n_edges + kSharedThreads - 1) / kSharedThreads;
    const int64_t resident = static_cast<int64_t>(sms) * per_sm;
    if (blocks > resident) blocks = resident;
    recount_gather_kernel<kPacked, true>
        <<<static_cast<unsigned>(blocks), kSharedThreads, bytes, st>>>(
            m, n_mask, s, o, n_edges);
    *branch = 0;
  } else {
    int64_t blocks = (n_edges + kGlobalThreads - 1) / kGlobalThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    recount_gather_kernel<kPacked, false>
        <<<static_cast<unsigned>(blocks), kGlobalThreads, 0, st>>>(
            m, n_mask, s, o, n_edges);
    *branch = 1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); *branch is 0
// when the mask was staged in shared memory, 1 when it was read through
// __ldg, -1 when nothing was launched.
int sbr_recount_gather_packed(const void* mask, int64_t n_mask, const void* src,
                              void* out, int64_t n_edges, void* stream,
                              int* branch) {
  return launch<true>(mask, n_mask, src, out, n_edges, stream, branch);
}

int sbr_recount_gather_bool(const void* mask, int64_t n_mask, const void* src,
                            void* out, int64_t n_edges, void* stream,
                            int* branch) {
  return launch<false>(mask, n_mask, src, out, n_edges, stream, branch);
}

}  // extern "C"
