// Host-side graph preprocessing for the explicit-agent simulation, bound
// with ctypes by sbr_tpu_torch/native/__init__.py.
//
// The infection kernel (csrc/infection_update.cu) reads dst-sorted edge lists
// with a row-pointer table. numpy's stable argsort of 10^8 edges is an
// O(E log E) comparison sort; destination ids are small integers, so a
// counting sort builds the sorted edges, the row-pointer table and the
// in-degree vector in one O(E + N) pass. The Erdős–Rényi sampler draws the
// edge pairs from a splitmix64 stream, the stream of the JAX package's native
// sampler, so a seed gives the same graph in both packages.
//
// Built at first use by sbr_tpu_torch/_build.py (build_host):
//   g++ -O3 -shared -fPIC graphgen.cpp -o _build/graphgen-<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Counting-sort edges by destination (stable in source order).
//
//   src, dst       : e input edges, dst values in [0, n)
//   src_out,dst_out: e sorted outputs
//   row_ptr        : n+1 outputs; edges of dst i occupy
//                    [row_ptr[i], row_ptr[i+1])
//   indeg          : n outputs; in-degree per destination
//
// Returns 0 on success, 1 on a dst id out of range.
int sort_edges_by_dst(const int32_t* src, const int32_t* dst, int64_t e,
                      int32_t n, int32_t* src_out, int32_t* dst_out,
                      int64_t* row_ptr, int32_t* indeg) {
  std::vector<int64_t> count(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    const int32_t d = dst[i];
    if (d < 0 || d >= n) return 1;
    ++count[static_cast<size_t>(d) + 1];
  }
  for (int32_t i = 0; i < n; ++i) {
    indeg[i] = static_cast<int32_t>(count[static_cast<size_t>(i) + 1]);
    count[static_cast<size_t>(i) + 1] += count[i];
  }
  std::memcpy(row_ptr, count.data(), (static_cast<size_t>(n) + 1) * sizeof(int64_t));

  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t p = cursor[dst[i]]++;
    src_out[p] = src[i];
    dst_out[p] = dst[i];
  }
  return 0;
}

// Sparse directed Erdős–Rényi edge sampling with a splitmix64 stream:
// e uniform (src, dst) pairs with self-loops re-drawn. Deterministic in seed.
void er_edges(int32_t n, int64_t e, uint64_t seed, int32_t* src, int32_t* dst) {
  uint64_t state = seed;
  auto next = [&state]() -> uint64_t {
    state += 0x9e3779b97f4a7c15ULL;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  };
  const uint64_t un = static_cast<uint64_t>(n);
  for (int64_t i = 0; i < e; ++i) {
    int32_t s = static_cast<int32_t>(next() % un);
    int32_t d = static_cast<int32_t>(next() % un);
    while (d == s && n > 1) d = static_cast<int32_t>(next() % un);
    src[i] = s;
    dst[i] = d;
  }
}

}  // extern "C"
