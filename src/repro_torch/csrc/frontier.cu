// Sparse phase-2 frontier step kernels (kernels 3 and 4).
//
// Kernel 3, probe: replaces the Pallas kernel
//   src/repro/kernels/frontier_fused.py::_probe_kernel (via _row_call,
//   driven by expand_frontier_loop_fused). Per raw candidate (cq, cv, ok):
//   the visited-bitset test, the answered-query test and the validity
//   mask, then the packed key (cq << vbits) | cv or SENTINEL.
// Kernel 4, classify_emit: replaces the Pallas kernel
//   src/repro/kernels/frontier_fused.py::_classify_emit_kernel (via
//   _classify_call). The phase-1 packed verdict (verdict.cuh, shared with
//   kernel 1) on each survivor, the s == t early positive, and the
//   next-frontier emit: UNKNOWN survivors keep their key, the rest emit
//   SENTINEL.
//
// Bound on an H100 (3.35 TB/s): both are elementwise with one gather, and
// what they must move depends on the data. Kernel 3 reads ok and writes
// the key for every candidate (8 B); only a valid candidate needs its
// (cq, cv), its visited word and its query's answered flag (16 B more).
// At the phase-2 path's largest step (cap * W = 4096 * 32 candidates, a
// few hundred valid) that is ~1 MB, >= 0.3 us. Kernel 4 reads the key
// and writes (verdict, front) for every slot (12 B); a live slot also
// reads eq, and one that is not its query's target reads 2 x 16 B meta
// rows + 8K B slab row. At these sizes a launch (a few us) outweighs the
// bytes. Design: one thread per candidate, and a thread reads only what
// its result depends on: kernel 3 loads (cq, cv) only where ok is set
// and reads the visited word itself from visited[cq, cv >> 5] (the
// reference gathers it in XLA first and writes it back to HBM), with
// shifts and masks on uint32_t; kernel 4 touches no row of a dead slot
// or of an s == t slot. Keeping the whole BFS step on the device
// (compaction and dedup in the kernel, no host sync per step) is later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "verdict.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void probe_kernel(const int32_t* __restrict__ cq,
                             const int32_t* __restrict__ cv,
                             const int32_t* __restrict__ ok,
                             const int32_t* __restrict__ visited,
                             const int32_t* __restrict__ pos,
                             int32_t* __restrict__ keys, int64_t c,
                             int64_t n_words, int vbits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c) return;
  int32_t key = reach::SENTINEL;
  if (__ldg(ok + i) != 0) {
    const int32_t q = __ldg(cq + i);
    const int32_t v = __ldg(cv + i);
    const uint32_t word = static_cast<uint32_t>(
        __ldg(visited + static_cast<int64_t>(q) * n_words + (v >> 5)));
    const bool seen = ((word >> (static_cast<uint32_t>(v) & 31u)) & 1u) != 0u;
    if (!seen && __ldg(pos + q) == 0) key = (q << vbits) | v;
  }
  keys[i] = key;
}

__global__ void classify_emit_kernel(const int32_t* __restrict__ meta_s,
                                     const int32_t* __restrict__ meta_t,
                                     const int32_t* __restrict__ slab_s,
                                     const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ eq,
                                     int32_t* __restrict__ verdict,
                                     int32_t* __restrict__ front, int64_t c,
                                     int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= c) return;
  const int32_t key = __ldg(keys + i);
  if (key == reach::SENTINEL) {            // dead slot: no row is read
    verdict[i] = reach::NEG;
    front[i] = reach::SENTINEL;
    return;
  }
  const int v = __ldg(eq + i) != 0
                    ? reach::POS
                    : reach::packed_verdict(reach::load_row4(meta_s, i),
                                            reach::load_row4(meta_t, i),
                                            slab_s + i * 2 * k, k);
  verdict[i] = v;
  front[i] = v == reach::UNKNOWN ? key : reach::SENTINEL;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int reach_probe(const int32_t* cq, const int32_t* cv,
                           const int32_t* ok, const int32_t* visited,
                           const int32_t* pos, int32_t* keys, int64_t c,
                           int64_t n_words, int vbits, cudaStream_t stream) {
  probe_kernel<<<blocks_for(c), kThreads, 0, stream>>>(cq, cv, ok, visited,
                                                       pos, keys, c, n_words,
                                                       vbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_classify_emit(const int32_t* meta_s,
                                   const int32_t* meta_t,
                                   const int32_t* slab_s, const int32_t* keys,
                                   const int32_t* eq, int32_t* verdict,
                                   int32_t* front, int64_t c, int k,
                                   cudaStream_t stream) {
  classify_emit_kernel<<<blocks_for(c), kThreads, 0, stream>>>(
      meta_s, meta_t, slab_s, keys, eq, verdict, front, c, k);
  return static_cast<int>(cudaGetLastError());
}
