// Merge + top-gap cover of begin-sorted interval rows (kernel 5).
//
// Replaces the Pallas kernel
//   src/repro/kernels/merge_cover.py::merge_cover_sorted_rows
//   (body _merge_cover_kernel), which computes, bit for bit, the vmapped
//   src/repro/core/build/merge_kernels.py::_merge_sorted_row +
//   _topgap_cover_row. Per row of m begin-sorted (b, e, x) slots: the
//   union merge with exact-coverage tracking (overlapping intervals
//   merge; touching ones only when the exactness agrees), then the cover
//   that keeps the k-1 largest gaps between consecutive merged runs (ties
//   keep the leftmost gap) and fills every other gap in. Each output
//   group of runs becomes one interval, exact only if it is one exact
//   run; groups past w_out are dropped, empty output slots read
//   INVALID / -1 / 0, and cnt = min(runs, k).
//
// Bound on an H100 (3.35 TB/s): the call must read 12 B per valid slot
// and the first INVALID begin of each row, and write 12 B per output
// slot plus the count. At the build's widest wave (2^21 rows of m = 9
// on the 4M-node graph) that is 234 MB, 70 us, 90% of it the outputs; a
// tree round of a few hub rows reads a few kB and is bound by latency
// instead: one thread walks its row's m slots one after another.
//
// Design: one thread per row, two passes over the row's valid prefix
// (INVALID begins sort to the tail, so the walk stops at the first one),
// registers only. Pass 1 runs the merge recurrence and keeps the k-1
// largest (gap, run index) pairs in a small array sorted by gap, then
// index; a new gap enters only when strictly larger, so ties keep the
// leftmost. Pass 2 runs the recurrence again and emits each output
// group as it closes, cutting after the kept runs. The TPU kernel's
// VMEM scratch planes, masked-argmax rounds and prefix scan exist
// because its vector unit cannot scatter per lane; a thread can. Reads
// are strided by m between neighbouring threads (each thread walks its
// own row); a warp per row or staging rows through shared memory is
// later work. Arithmetic that can pass the int32 range next to INVALID
// (ce + 1, bi - 1, the gaps) is done in int64: it equals the
// reference's int32 arithmetic wherever that does not wrap.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int32_t INVALID = INT32_MAX;
constexpr int kThreads = 128;

// The union-merge recurrence of _merge_sorted_row over valid slots.
struct Sweep {
  int64_t cb = 0, ce = -1, ece = -2;
  bool holed = true;
  int runs = 0;  // runs opened so far

  __device__ __forceinline__ bool exact() const {
    return !holed && ece >= ce;
  }

  // Feed one valid slot. Returns true when it closes the open run (it
  // opens the next one); the closed run is then (rb, re, rx).
  __device__ __forceinline__ bool feed(int64_t bi, int64_t ei, bool xi,
                                       int64_t& rb, int64_t& re, bool& rx) {
    const bool opened = runs > 0;
    const bool cur_exact = exact();
    if (opened && (bi <= ce || (bi == ce + 1 && cur_exact == xi))) {
      if (xi) {
        if (bi <= ece + 1) {
          ece = ece > ei ? ece : ei;
        } else {
          holed = true;
        }
      }
      ce = ce > ei ? ce : ei;
      return false;
    }
    rb = cb;
    re = ce;
    rx = cur_exact;
    cb = bi;
    ce = ei;
    ece = xi ? ei : bi - 1;
    holed = false;
    runs += 1;
    return opened;
  }
};

template <int KM>
__global__ void merge_cover_kernel(const int32_t* __restrict__ cb,
                                   const int32_t* __restrict__ ce,
                                   const int32_t* __restrict__ cx,
                                   int32_t* __restrict__ nb,
                                   int32_t* __restrict__ ne,
                                   int32_t* __restrict__ nx,
                                   int32_t* __restrict__ cnt, int64_t rows,
                                   int m, int k, int w_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= rows) return;
  const int32_t* b = cb + r * m;
  const int32_t* e = ce + r * m;
  const int32_t* x = cx + r * m;
  const int keep = k - 1;

  // ---- pass 1: the k-1 largest gaps, sorted by (gap desc, run asc) ----
  int64_t kg[KM];
  int ki[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    kg[j] = -1;  // gaps are >= 0: an empty entry loses to any gap
    ki[j] = INT_MAX;
  }
  int n_valid = 0;
  {
    Sweep s;
    int64_t rb = 0, re = 0;
    bool rx = false;
    for (; n_valid < m; ++n_valid) {
      const int32_t bi = __ldg(b + n_valid);
      if (bi == INVALID) break;
      if (s.feed(bi, __ldg(e + n_valid), __ldg(x + n_valid) != 0, rb, re,
                 rx)) {
        int64_t g = static_cast<int64_t>(bi) - re - 1;  // after run runs-2
        int gi = s.runs - 2;
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (g > kg[j] || (g == kg[j] && gi < ki[j])) {
            const int64_t tg = kg[j];
            const int ti = ki[j];
            kg[j] = g;
            ki[j] = gi;
            g = tg;
            gi = ti;
          }
        }
      }
    }
  }

  // ---- pass 2: emit the output groups, cutting after the kept runs ----
  Sweep s;
  int out = 0, g_runs = 0;
  int64_t gb = 0, ge = 0;
  bool gx = false;
  int64_t rb = 0, re = 0;
  bool rx = false;
  int32_t* ob = nb + r * w_out;
  int32_t* oe = ne + r * w_out;
  int32_t* ox = nx + r * w_out;
  auto add_run = [&]() {
    gb = g_runs == 0 ? rb : (rb < gb ? rb : gb);
    ge = g_runs == 0 ? re : (re > ge ? re : ge);
    gx = rx;
    g_runs += 1;
  };
  auto emit = [&]() {
    if (out < w_out) {
      ob[out] = static_cast<int32_t>(gb);
      oe[out] = static_cast<int32_t>(ge);
      ox[out] = (g_runs == 1 && gx) ? 1 : 0;
    }
    out += 1;
    g_runs = 0;
  };
  for (int i = 0; i < n_valid; ++i) {
    if (s.feed(__ldg(b + i), __ldg(e + i), __ldg(x + i) != 0, rb, re, rx)) {
      add_run();
      const int closed = s.runs - 2;
      bool cut = false;
#pragma unroll
      for (int j = 0; j < KM; ++j) cut |= (j < keep) && ki[j] == closed;
      if (cut) emit();
    }
  }
  if (s.runs > 0) {
    rb = s.cb;
    re = s.ce;
    rx = s.exact();
    add_run();
    emit();
  }
  for (int j = out; j < w_out; ++j) {
    ob[j] = INVALID;
    oe[j] = -1;
    ox[j] = 0;
  }
  cnt[r] = s.runs < k ? s.runs : k;
}

}  // namespace

extern "C" int reach_merge_cover(const int32_t* cb, const int32_t* ce,
                                 const int32_t* cx, int32_t* nb, int32_t* ne,
                                 int32_t* nx, int32_t* cnt, int64_t rows,
                                 int m, int k, int w_out,
                                 cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (m < 1 || k < 1 || k - 1 > 32 || w_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  if (k - 1 <= 8) {
    merge_cover_kernel<8><<<blocks, kThreads, 0, stream>>>(
        cb, ce, cx, nb, ne, nx, cnt, rows, m, k, w_out);
  } else {
    merge_cover_kernel<32><<<blocks, kThreads, 0, stream>>>(
        cb, ce, cx, nb, ne, nx, cnt, rows, m, k, w_out);
  }
  return static_cast<int>(cudaGetLastError());
}
