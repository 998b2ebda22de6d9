// Phase-1 interval-stab classification kernels (kernels 1 and 2).
//
// Kernel 1, stab_packed: replaces the Pallas kernel
//   src/repro/kernels/interval_stab.py::interval_stab_classify_packed
//   (body _stab_packed_kernel, core _packed_verdict).
// Kernel 2, stab_naive: replaces the Pallas kernel
//   src/repro/kernels/interval_stab.py::interval_stab_classify
//   (body _stab_kernel): the 12-operand layout, W-word seeds, unsaturated
//   levels; used when the fused layout does not fit (seeds > 32 or
//   n > 2^24).
//
// Bound on an H100 (3.35 TB/s): both are gathers with no reuse. Kernel 1
// moves 8 B of (cs, ct) + 2 x 16 B meta rows + 8K B slab row + 4 B verdict
// per query: 108 B at K = 8, so 2^20 queries need >= 34 us. Kernel 2 moves
// 8 B ids + 20 B scalars + 12K B of begins/ends/exact + 16W B seeds + 4 B.
// Design: one thread per query does its own row gathers (the reference
// leaves them to XLA as three or twelve separate gather passes, each
// writing its rows back to HBM before the stab kernel reads them again),
// so every byte is read once and only the verdict is written. The meta
// row is one 16-byte load. The cs == ct early positive is folded into the
// same pass. Rows land in random order, so each gather touches its own
// 32-byte sectors; sorting queries by source row is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "verdict.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void stab_packed_kernel(const int32_t* __restrict__ meta,
                                   const int32_t* __restrict__ slab,
                                   const int32_t* __restrict__ cs,
                                   const int32_t* __restrict__ ct,
                                   int32_t* __restrict__ out, int64_t q,
                                   int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= q) return;
  const int32_t s = __ldg(cs + i);
  const int32_t t = __ldg(ct + i);
  if (s == t) {
    out[i] = reach::POS;
    return;
  }
  const int4 ms = reach::load_row4(meta, s);
  const int4 mt = reach::load_row4(meta, t);
  out[i] = reach::packed_verdict(ms, mt, slab + static_cast<int64_t>(s) * 2 * k,
                                 k);
}

__global__ void stab_naive_kernel(
    const int32_t* __restrict__ pi, const int32_t* __restrict__ tau,
    const int32_t* __restrict__ lvl, const int32_t* __restrict__ begins,
    const int32_t* __restrict__ ends, const int32_t* __restrict__ exact,
    const int32_t* __restrict__ sp, const int32_t* __restrict__ sm,
    const int32_t* __restrict__ cs, const int32_t* __restrict__ ct,
    int32_t* __restrict__ out, int64_t q, int k, int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= q) return;
  const int32_t s = __ldg(cs + i);
  const int32_t t = __ldg(ct + i);
  if (s == t) {
    out[i] = reach::POS;
    return;
  }
  const int32_t pt = __ldg(pi + t);
  const int64_t row = static_cast<int64_t>(s) * k;
  bool hit_any = false, hit_exact = false;
  for (int j = 0; j < k; ++j) {
    const bool h = (__ldg(begins + row + j) <= pt) &&
                   (pt <= __ldg(ends + row + j));
    hit_any |= h;
    hit_exact |= h && (__ldg(exact + row + j) != 0);
  }
  bool neg = __ldg(tau + s) >= __ldg(tau + t);
  neg |= __ldg(lvl + s) <= __ldg(lvl + t);
  bool seed_pos = false;
  const int64_t ws = static_cast<int64_t>(s) * w;
  const int64_t wt = static_cast<int64_t>(t) * w;
  for (int j = 0; j < w; ++j) {
    const uint32_t sps = static_cast<uint32_t>(__ldg(sp + ws + j));
    const uint32_t sms = static_cast<uint32_t>(__ldg(sm + ws + j));
    const uint32_t spt = static_cast<uint32_t>(__ldg(sp + wt + j));
    const uint32_t smt = static_cast<uint32_t>(__ldg(sm + wt + j));
    seed_pos |= (sps & smt) != 0u;
    neg |= (sms & ~smt) != 0u;
    neg |= (spt & ~sps) != 0u;
  }
  neg |= !hit_any;
  out[i] = (hit_exact || seed_pos) ? reach::POS
                                   : (neg ? reach::NEG : reach::UNKNOWN);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int reach_stab_packed(const int32_t* meta, const int32_t* slab,
                                 const int32_t* cs, const int32_t* ct,
                                 int32_t* out, int64_t q, int k,
                                 cudaStream_t stream) {
  stab_packed_kernel<<<blocks_for(q), kThreads, 0, stream>>>(meta, slab, cs,
                                                             ct, out, q, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_stab_naive(const int32_t* pi, const int32_t* tau,
                                const int32_t* lvl, const int32_t* begins,
                                const int32_t* ends, const int32_t* exact,
                                const int32_t* sp, const int32_t* sm,
                                const int32_t* cs, const int32_t* ct,
                                int32_t* out, int64_t q, int k, int w,
                                cudaStream_t stream) {
  stab_naive_kernel<<<blocks_for(q), kThreads, 0, stream>>>(
      pi, tau, lvl, begins, ends, exact, sp, sm, cs, ct, out, q, k, w);
  return static_cast<int>(cudaGetLastError());
}
