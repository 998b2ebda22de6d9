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
// (INVALID begins sort to the tail, so the walk stops at the first one).
// Pass 1 runs the merge recurrence and keeps the k-1 largest (gap, run
// index) pairs in a small array sorted by gap, then index; a new gap
// enters only when strictly larger, so ties keep the leftmost. Pass 2
// runs the recurrence again and emits each output group as it closes,
// cutting after the kept runs. The TPU kernel's VMEM scratch planes,
// masked-argmax rounds and prefix scan exist because its vector unit
// cannot scatter per lane; a thread can. Arithmetic that can pass the
// int32 range next to INVALID (ce + 1, bi - 1, the gaps) is done in
// int64: it equals the reference's int32 arithmetic wherever that does
// not wrap.
//
// A block holds kRows consecutive rows, and moves them as slabs: the
// rows' outputs are contiguous (rows r0 .. r0 + kRows - 1, w_out words
// each, per array), so each thread writes its row's w_out words of each
// array, the INVALID / -1 / 0 fill included, into shared memory, and the
// block then writes the three slabs out with 16-byte stores (where the
// row walk's own stores would touch a sector per row and slot). Narrow
// rows (m <= kMaxStagedM, the build's widest wave has m 9) also stage
// the cb slab with 16-byte loads, so each thread walks its row's begins
// in shared memory; ce and cx are read from device memory for valid
// slots only. (Fetching those into shared rows before the walk too was
// measured slower on rows shaped like the build's largest call: it
// costs shared memory.)
// Shared rows have an odd stride (m | 1, w_out | 1), so the threads of a
// warp, each on its own row, hit distinct banks. Wider rows (the tree
// rounds' m 513, waves of m 65 to 257) walk cb in device memory, and
// w_out > kMaxStagedW stores straight from the walk: the wrapper's plan
// (kernels/merge_cover.py::plan) picks both by shape.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int32_t INVALID = INT32_MAX;
constexpr int kRows = 128;        // rows (threads) a block
constexpr int kMaxStagedM = 32;   // cb slabs staged up to this m
constexpr int kMaxStagedW = 64;   // outputs staged up to this w_out

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

// One thread's row: the two passes, its outputs through ob/oe/ox (in
// shared memory or device memory), the count returned. b(i) reads the
// row's begin i (from shared or device memory); e, x are its ends and
// exact flags in device memory.
template <int KM, typename B>
__device__ __forceinline__ int cover_row(B b, const int32_t* __restrict__ e,
                                         const int32_t* __restrict__ x,
                                         int32_t* ob, int32_t* oe,
                                         int32_t* ox, int m, int k,
                                         int w_out) {
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
      const int32_t bi = b(n_valid);
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
    if (s.feed(b(i), __ldg(e + i), __ldg(x + i) != 0, rb, re, rx)) {
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
  return s.runs < k ? s.runs : k;
}

// Copies `words` int32 of a [rows, width] slab between device memory
// (rows contiguous) and shared memory (row stride `stride`), 16 bytes a
// device access where the device side is 16-byte aligned. Each thread
// steps its (row, column) by a fixed amount instead of dividing.
template <bool kToShared>
__device__ __forceinline__ void move_slab(int32_t* dev, int32_t* sh,
                                          int words, int width,
                                          int stride) {
  const bool vec = (reinterpret_cast<uintptr_t>(dev) & 15) == 0;
  const int quads = vec ? words / 4 : 0;
  const int step = 4 * blockDim.x, dr = step / width, dc = step % width;
  int r = 4 * threadIdx.x / width, c = 4 * threadIdx.x % width;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    int v[4];
    if (kToShared) {
      const int4 d = __ldg(reinterpret_cast<const int4*>(dev) + q);
      v[0] = d.x;
      v[1] = d.y;
      v[2] = d.z;
      v[3] = d.w;
    }
    int rr = r, cc = c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kToShared) {
        sh[rr * stride + cc] = v[j];
      } else {
        v[j] = sh[rr * stride + cc];
      }
      if (++cc == width) {
        cc = 0;
        ++rr;
      }
    }
    if (!kToShared)
      reinterpret_cast<int4*>(dev)[q] = make_int4(v[0], v[1], v[2], v[3]);
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
  for (int i = 4 * quads + threadIdx.x; i < words; i += blockDim.x) {
    const int rr = i / width, cc = i - rr * width;
    if (kToShared) {
      sh[rr * stride + cc] = __ldg(dev + i);
    } else {
      dev[i] = sh[rr * stride + cc];
    }
  }
}

template <int KM, bool kStageCb, bool kStageOut>
__global__ void __launch_bounds__(kRows)
    merge_cover_kernel(const int32_t* __restrict__ cb,
                       const int32_t* __restrict__ ce,
                       const int32_t* __restrict__ cx,
                       int32_t* __restrict__ nb, int32_t* __restrict__ ne,
                       int32_t* __restrict__ nx, int32_t* __restrict__ cnt,
                       int64_t rows, int m, int k, int w_out) {
  extern __shared__ int32_t sm[];
  const int sb = m | 1, so = w_out | 1;      // odd row strides
  int32_t* cb_s = sm;                                    // [kRows, sb]
  int32_t* out_s = sm + (kStageCb ? kRows * sb : 0);     // 3 x [kRows, so]
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rv = static_cast<int>(rows - r0 < kRows ? rows - r0 : kRows);
  const int tid = threadIdx.x;
  const int64_t r = r0 + tid;

  if (kStageCb) {
    move_slab<true>(const_cast<int32_t*>(cb) + r0 * m, cb_s, rv * m, m, sb);
    __syncthreads();
  }
  if (tid < rv) {
    int32_t* ob = kStageOut ? out_s + tid * so : nb + r * w_out;
    int32_t* oe = kStageOut ? out_s + (kRows + tid) * so : ne + r * w_out;
    int32_t* ox = kStageOut ? out_s + (2 * kRows + tid) * so
                            : nx + r * w_out;
    const int32_t* e = ce + r * m;
    const int32_t* x = cx + r * m;
    int c;
    if (kStageCb) {
      const int32_t* b = cb_s + tid * sb;
      c = cover_row<KM>([b](int i) { return b[i]; }, e, x, ob, oe, ox, m, k,
                        w_out);
    } else {
      const int32_t* b = cb + r * m;
      c = cover_row<KM>([b](int i) { return __ldg(b + i); }, e, x, ob, oe,
                        ox, m, k, w_out);
    }
    cnt[r] = c;
  }
  if (kStageOut) {
    __syncthreads();
    const int words = rv * w_out;
    move_slab<false>(nb + r0 * w_out, out_s, words, w_out, so);
    move_slab<false>(ne + r0 * w_out, out_s + kRows * so, words, w_out, so);
    move_slab<false>(nx + r0 * w_out, out_s + 2 * kRows * so, words, w_out,
                     so);
  }
}

template <int KM>
int launch(const int32_t* cb, const int32_t* ce, const int32_t* cx,
           int32_t* nb, int32_t* ne, int32_t* nx, int32_t* cnt,
           int64_t rows, int m, int k, int w_out, bool stage_cb,
           bool stage_out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  const int64_t smem = 4 * kRows * ((stage_cb ? (m | 1) : 0) +
                                    (stage_out ? 3 * (w_out | 1) : 0));
  auto kernel = stage_cb
                    ? (stage_out ? merge_cover_kernel<KM, true, true>
                                 : merge_cover_kernel<KM, true, false>)
                    : (stage_out ? merge_cover_kernel<KM, false, true>
                                 : merge_cover_kernel<KM, false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kRows, static_cast<size_t>(smem), stream>>>(
      cb, ce, cx, nb, ne, nx, cnt, rows, m, k, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stage_cb and stage_out: the wrapper's plan (kernels/merge_cover.py::
// plan); refused beyond kMaxStagedM and kMaxStagedW.
extern "C" int reach_merge_cover(const int32_t* cb, const int32_t* ce,
                                 const int32_t* cx, int32_t* nb, int32_t* ne,
                                 int32_t* nx, int32_t* cnt, int64_t rows,
                                 int m, int k, int w_out, int stage_cb,
                                 int stage_out, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (m < 1 || k < 1 || k - 1 > 32 || w_out < 1 ||
      (stage_cb && m > kMaxStagedM) || (stage_out && w_out > kMaxStagedW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k - 1 <= 8)
    return launch<8>(cb, ce, cx, nb, ne, nx, cnt, rows, m, k, w_out,
                     stage_cb, stage_out, stream);
  return launch<32>(cb, ce, cx, nb, ne, nx, cnt, rows, m, k, w_out,
                    stage_cb, stage_out, stream);
}
