// Phase-1 verdict rules, in the pieces the kernels combine: one source for
// the phase-1 stab kernels (interval_stab.cu: kernel 1 on the packed
// layout, kernel 2 on the 12-array layout) and the phase-2 classify+emit
// kernel (frontier.cu), as the reference keeps one rule set for its
// kernels (src/repro/kernels/interval_stab.py::_packed_verdict and
// _stab_kernel).
//
// A query (s, t) is POS on an exact hit or a seed positive, else NEG on a
// filter or no hit at all, else UNKNOWN. The hit and seed tests are ORs
// over slots and seed words, so a group of lanes may each test a part and
// OR the flags; the filters and the combine then run once. Only a query
// with a hit, but neither an exact hit nor a seed positive, needs the
// filters (the tau and level filters and the seed negatives).
//
// Packed meta row (4 int32): word0 = pi | min(blevel, 255) << 24,
// word1 = tau, word2 = s+ seed word, word3 = s- seed word.
// Packed slab row (2K int32): K begins with the exact flag in the sign
// bit, then K ends.
#pragma once

#include <cstdint>

namespace reach {

constexpr int NEG = 0;
constexpr int POS = 1;
constexpr int UNKNOWN = 2;
constexpr int32_t SENTINEL = 0x7FFFFFFF;

// One interval slot of the packed layout against pi(t).
__device__ __forceinline__ void packed_slot(int32_t braw, int32_t end,
                                            int32_t pt, bool& hit_any,
                                            bool& hit_exact) {
  const bool h = ((braw & 0x7FFFFFFF) <= pt) && (pt <= end);
  hit_any |= h;
  hit_exact |= h && (braw < 0);
}

// One interval slot of the 12-array layout (exact flag in its own array).
__device__ __forceinline__ void naive_slot(int32_t begin, int32_t end,
                                           int32_t exact, int32_t pt,
                                           bool& hit_any, bool& hit_exact) {
  const bool h = (begin <= pt) && (pt <= end);
  hit_any |= h;
  hit_exact |= h && (exact != 0);
}

// The seed rules (§5.1) on one word of s+ and s- of s and of t: a
// positive when s+ of s meets s- of t, a negative when s- of s or s+ of t
// holds a seed the other lacks.
__device__ __forceinline__ bool seed_pos_word(uint32_t sps, uint32_t smt) {
  return (sps & smt) != 0u;
}

__device__ __forceinline__ bool seed_neg_word(uint32_t sps, uint32_t sms,
                                              uint32_t spt, uint32_t smt) {
  return ((sms & ~smt) != 0u) || ((spt & ~sps) != 0u);
}

// The tau filter (Eq. 11) and the unsaturated level filter (§5.2) of the
// 12-array layout.
__device__ __forceinline__ bool naive_filters(int32_t tau_s, int32_t tau_t,
                                              int32_t lvl_s, int32_t lvl_t) {
  return (tau_s >= tau_t) || (lvl_s <= lvl_t);
}

__device__ __forceinline__ int verdict_of(bool hit_any, bool hit_exact,
                                          bool seed_pos, bool neg) {
  return (hit_exact || seed_pos) ? POS : ((neg || !hit_any) ? NEG : UNKNOWN);
}

// pi(t), 24 bits of the packed meta row's word0.
__device__ __forceinline__ int32_t packed_pi(int4 m) { return m.x & 0xFFFFFF; }

// The packed layout's filters and combine, given the OR of its slot tests:
// the tau filter, the level filter (suppressed by a saturated source
// level) and the one-word seed rules, all from the two meta rows.
__device__ __forceinline__ int packed_combine(bool hit_any, bool hit_exact,
                                              int4 ms, int4 mt) {
  const uint32_t ls = (static_cast<uint32_t>(ms.x) >> 24) & 0xFFu;
  const uint32_t lt = (static_cast<uint32_t>(mt.x) >> 24) & 0xFFu;
  bool neg = ms.y >= mt.y;                        // tau filter (Eq. 11)
  neg |= (ls < 255u) && (ls <= lt);               // level filter, saturating
  const auto sps = static_cast<uint32_t>(ms.z);
  const auto sms = static_cast<uint32_t>(ms.w);
  const auto spt = static_cast<uint32_t>(mt.z);
  const auto smt = static_cast<uint32_t>(mt.w);
  neg |= seed_neg_word(sps, sms, spt, smt);
  return verdict_of(hit_any, hit_exact, seed_pos_word(sps, smt), neg);
}

// The packed verdict of one query by one thread over its whole slab row.
__device__ __forceinline__ int packed_verdict(int4 ms, int4 mt,
                                              const int32_t* __restrict__ slab,
                                              int k) {
  const int32_t pt = packed_pi(mt);
  bool hit_any = false, hit_exact = false;
  for (int j = 0; j < k; ++j)
    packed_slot(__ldg(slab + j), __ldg(slab + k + j), pt, hit_any, hit_exact);
  return packed_combine(hit_any, hit_exact, ms, mt);
}

__device__ __forceinline__ int4 load_row4(const int32_t* __restrict__ base,
                                          int64_t row) {
  return __ldg(reinterpret_cast<const int4*>(base) + row);
}

}  // namespace reach
