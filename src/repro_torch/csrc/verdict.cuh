// Phase-1 verdict rules on the gather-fused packed layout, shared by the
// phase-1 stab kernel (interval_stab.cu) and the phase-2 classify+emit
// kernel (frontier.cu): one source for both, as the reference keeps one
// `_packed_verdict` for its two Pallas kernels
// (src/repro/kernels/interval_stab.py::_packed_verdict).
//
// meta row (4 int32): word0 = pi | min(blevel, 255) << 24, word1 = tau,
// word2 = s+ seed word, word3 = s- seed word.
// slab row (2K int32): K begins with the exact flag in the sign bit, then
// K ends.
#pragma once

#include <cstdint>

namespace reach {

constexpr int NEG = 0;
constexpr int POS = 1;
constexpr int UNKNOWN = 2;
constexpr int32_t SENTINEL = 0x7FFFFFFF;

__device__ __forceinline__ int packed_verdict(int4 ms, int4 mt,
                                              const int32_t* __restrict__ slab,
                                              int k) {
  const int32_t pt = mt.x & 0xFFFFFF;             // pi(t), 24 bits
  bool hit_any = false, hit_exact = false;
  for (int j = 0; j < k; ++j) {
    const int32_t braw = __ldg(slab + j);
    const int32_t e = __ldg(slab + k + j);
    const bool h = ((braw & 0x7FFFFFFF) <= pt) && (pt <= e);
    hit_any |= h;
    hit_exact |= h && (braw < 0);
  }
  const uint32_t ls = (static_cast<uint32_t>(ms.x) >> 24) & 0xFFu;
  const uint32_t lt = (static_cast<uint32_t>(mt.x) >> 24) & 0xFFu;
  bool neg = ms.y >= mt.y;                        // tau filter (Eq. 11)
  neg |= (ls < 255u) && (ls <= lt);               // level filter, saturating
  const uint32_t sps = static_cast<uint32_t>(ms.z);
  const uint32_t sms = static_cast<uint32_t>(ms.w);
  const uint32_t spt = static_cast<uint32_t>(mt.z);
  const uint32_t smt = static_cast<uint32_t>(mt.w);
  const bool seed_pos = (sps & smt) != 0u;
  neg |= (sms & ~smt) != 0u;
  neg |= (spt & ~sps) != 0u;
  neg |= !hit_any;
  return (hit_exact || seed_pos) ? POS : (neg ? NEG : UNKNOWN);
}

__device__ __forceinline__ int4 load_row4(const int32_t* __restrict__ base,
                                          int64_t row) {
  return __ldg(reinterpret_cast<const int4*>(base) + row);
}

}  // namespace reach
