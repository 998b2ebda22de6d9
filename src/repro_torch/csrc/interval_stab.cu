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
// At the serving path's call (16,384 queries) that is well under a
// microsecond. What bounds the call instead: the launch itself (an empty
// kernel timed the same way takes ~5 us), the chain of dependent device-
// memory round trips a query waits through (every row is a random gather
// from a table of up to millions of rows), and the number of distinct
// 32-byte sectors the gathers touch: 12 a query for kernel 2's 12 arrays
// at K 1, W 2, where kernel 1's fused rows take 3 or 4.
//
// Design: each query takes a group of G lanes (G a power of two dividing
// 32; kernels/interval_stab.py::launch_shape sizes it and the grid so that
// the path's call covers every SM). Right after the ids, every lane issues
// its table loads at once: lane r the r-th V-wide piece of the K slots (V
// = 4, 16-byte loads, where K % 4 == 0, else 2 or 1 so every load is
// aligned) and, for kernel 2, the r-th seed word; kernel 1's two meta rows
// ride beside them. So a query waits through one dependent step after its
// ids, not one per slot or seed word. Kernel 2 loads in that step only
// what decides POS, or NEG on no hit (the slots, pi(t), s+ of s and s- of
// t); a second step loads the filters (tau, levels) and the other seed
// words only for a group whose query has a hit but neither an exact hit
// nor a seed positive: few queries on the serving path, so most touch 6
// sectors, not 12. The group ORs its lanes' flags with warp ballots, its
// first lane applies the filters and the combine (verdict.cuh, shared
// with kernel 4) and writes the verdict; the first lanes of a warp's
// groups write neighbouring verdicts. The cs == ct fold is the same pass.
// Whole warps take part in the ballots: no lane returns early. Where a
// group would have one lane (kernel 1 at K 1, 2 or 4), kernel 1 runs one
// thread a query over the whole row instead (stab_packed_one), which is
// faster at 2^20 queries. (Table loads through ld.global.nc.L1::
// no_allocate were slower at the path's call than __ldg, and are not
// used.)
//
// Kernel 1's owned-rows entry (reach_stab_packed_owned) serves the sharded
// placement (core/distributed.py::classify_sharded, compute-at-owner): each
// rank holds rows [base, base + n_loc) of meta and slab, t's meta row
// arrives by query position from the exchange ([Q, 4], the owned rows
// summed over the model group), and the rank computes the whole verdict of
// every query whose source row it owns, reading meta and slab at s - base,
// and writes 0 for the others, so one sum over the model group gives each
// query's verdict once. It is the same kernel on another row source (the
// ``Owned`` template flag), as the TPU kernel, which takes gathered rows
// (the reference's ``_prefetched`` form of ops.classify_queries), serves
// both placements.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "verdict.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// V consecutive int32 of a table row (V = 4, 2 or 1, aligned to 4V bytes).
template <int V>
__device__ __forceinline__ void load_row(const int32_t* p, int32_t (&v)[V]) {
  if constexpr (V == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (V == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

// The query and the lane of this thread, and its group's bits in a warp.
struct Group {
  int64_t i;         // query
  int r;             // lane in the group
  int base;          // the group's first lane in the warp
  unsigned mask;     // the group's lanes, from bit 0

  __device__ Group(int lanes) {
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    i = tid >> (__ffs(lanes) - 1);
    r = static_cast<int>(tid & (lanes - 1));
    base = (threadIdx.x & 31) & ~(lanes - 1);
    mask = lanes == 32 ? kFull : (1u << lanes) - 1u;
  }

  // OR of ``flag`` over the group; every lane of the warp must call it.
  __device__ bool any(bool flag) const {
    return ((__ballot_sync(kFull, flag) >> base) & mask) != 0u;
  }
};

// Where kernel 1 finds a query's rows: by node id in the whole tables, or
// (``Owned``, the sharded placement) t's meta row at the query's position
// in ``meta_t`` and the source's rows at s - base in this rank's shard of
// n_loc rows, for a source the shard owns.
struct Rows {
  const int32_t* meta_t;
  int64_t base, n_loc;
};

// The row of source s in the tables, and whether this rank owns it.
template <bool Owned>
__device__ __forceinline__ int64_t source_row(const Rows& rows, int32_t s,
                                              bool& own) {
  if constexpr (Owned) {
    const int64_t r = static_cast<int64_t>(s) - rows.base;
    own = r >= 0 && r < rows.n_loc;
    return r;
  }
  own = true;
  return s;
}

template <bool Owned>
__device__ __forceinline__ int4 target_meta(const int32_t* meta,
                                            const Rows& rows, int64_t i,
                                            int32_t t) {
  return Owned ? reach::load_row4(rows.meta_t, i) : reach::load_row4(meta, t);
}

// A group of one lane (K 1, 2 or 4) has nothing to vote on: one thread a
// query over its whole slab row. Compiled, it waits for t's meta row
// (pi(t)) before it issues the slab loads; at 2^20 queries over 2^22 rows
// that beats issuing all of a query's loads at once.
template <bool Owned>
__global__ void stab_packed_one(const int32_t* __restrict__ meta,
                                const int32_t* __restrict__ slab,
                                const int32_t* __restrict__ cs,
                                const int32_t* __restrict__ ct,
                                int32_t* __restrict__ out, int64_t q, int k,
                                Rows rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= q) return;
  const int32_t s = __ldg(cs + i);
  const int32_t t = __ldg(ct + i);
  bool own;
  const int64_t rs = source_row<Owned>(rows, s, own);
  if (!own) {
    out[i] = 0;
    return;
  }
  if (s == t) {
    out[i] = reach::POS;
    return;
  }
  out[i] = reach::packed_verdict(reach::load_row4(meta, rs),
                                 target_meta<Owned>(meta, rows, i, t),
                                 slab + rs * 2 * k, k);
}

template <int V, bool Owned>
__global__ void stab_packed_kernel(const int32_t* __restrict__ meta,
                                   const int32_t* __restrict__ slab,
                                   const int32_t* __restrict__ cs,
                                   const int32_t* __restrict__ ct,
                                   int32_t* __restrict__ out, int64_t q,
                                   int k, int lanes, Rows rows) {
  const Group g(lanes);
  const int pieces = k / V;
  bool live = false, own = true, hit_any = false, hit_exact = false;
  int4 ms = make_int4(0, 0, 0, 0), mt = ms;
  if (g.i < q) {
    const int32_t s = __ldg(cs + g.i);
    const int32_t t = __ldg(ct + g.i);
    const int64_t rs = source_row<Owned>(rows, s, own);
    live = own && s != t;
    if (live) {
      const int32_t* row = slab + rs * 2 * k;
      // every load of the query before any test
      mt = target_meta<Owned>(meta, rows, g.i, t);
      if (g.r == 0) ms = reach::load_row4(meta, rs);
      int32_t b[V], e[V];
      if (g.r < pieces) {
        load_row<V>(row + g.r * V, b);
        load_row<V>(row + k + g.r * V, e);
      }
      const int32_t pt = reach::packed_pi(mt);
      if (g.r < pieces) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          reach::packed_slot(b[v], e[v], pt, hit_any, hit_exact);
      }
      for (int p = g.r + lanes; p < pieces; p += lanes) {   // K > 32 V
        load_row<V>(row + p * V, b);
        load_row<V>(row + k + p * V, e);
#pragma unroll
        for (int v = 0; v < V; ++v)
          reach::packed_slot(b[v], e[v], pt, hit_any, hit_exact);
      }
    }
  }
  hit_any = g.any(hit_any);
  hit_exact = g.any(hit_exact);
  if (g.i < q && g.r == 0)
    out[g.i] = !own  ? 0
               : live ? reach::packed_combine(hit_any, hit_exact, ms, mt)
                      : reach::POS;
}

template <int V>
__global__ void stab_naive_kernel(
    const int32_t* __restrict__ pi, const int32_t* __restrict__ tau,
    const int32_t* __restrict__ lvl, const int32_t* __restrict__ begins,
    const int32_t* __restrict__ ends, const int32_t* __restrict__ exact,
    const int32_t* __restrict__ sp, const int32_t* __restrict__ sm,
    const int32_t* __restrict__ cs, const int32_t* __restrict__ ct,
    int32_t* __restrict__ out, int64_t q, int k, int w, int lanes) {
  const Group g(lanes);
  const int pieces = k / V;
  const bool slot = g.r < pieces, word = g.r < w;
  bool live = false, hit_any = false, hit_exact = false, seed_pos = false;
  int32_t s = 0, t = 0, sps = 0, smt = 0;
  int64_t ws = 0, wt = 0;
  if (g.i < q) {
    s = __ldg(cs + g.i);
    t = __ldg(ct + g.i);
    live = s != t;
  }
  // Step 1, right after the ids: what decides POS, or NEG on no hit: the
  // slot pieces against pi(t), and s+ of s against s- of t.
  if (live) {
    const int64_t row = static_cast<int64_t>(s) * k;
    ws = static_cast<int64_t>(s) * w;
    wt = static_cast<int64_t>(t) * w;
    int32_t b[V], e[V], x[V];
    if (slot) {
      load_row<V>(begins + row + g.r * V, b);
      load_row<V>(ends + row + g.r * V, e);
      load_row<V>(exact + row + g.r * V, x);
    }
    if (word) {
      sps = __ldg(sp + ws + g.r);
      smt = __ldg(sm + wt + g.r);
    }
    const int32_t pt = __ldg(pi + t);
    if (slot) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        reach::naive_slot(b[v], e[v], x[v], pt, hit_any, hit_exact);
    }
    if (word)
      seed_pos |= reach::seed_pos_word(static_cast<uint32_t>(sps),
                                       static_cast<uint32_t>(smt));
    for (int p = g.r + lanes; p < pieces; p += lanes) {   // K > 32 V
      load_row<V>(begins + row + p * V, b);
      load_row<V>(ends + row + p * V, e);
      load_row<V>(exact + row + p * V, x);
#pragma unroll
      for (int v = 0; v < V; ++v)
        reach::naive_slot(b[v], e[v], x[v], pt, hit_any, hit_exact);
    }
    for (int j = g.r + lanes; j < w; j += lanes)          // W > 32
      seed_pos |= reach::seed_pos_word(
          static_cast<uint32_t>(__ldg(sp + ws + j)),
          static_cast<uint32_t>(__ldg(sm + wt + j)));
  }
  hit_any = g.any(hit_any);
  hit_exact = g.any(hit_exact);
  seed_pos = g.any(seed_pos);
  // Step 2, only where step 1 leaves NEG and UNKNOWN open (a hit, no
  // exact hit, no seed positive): the seed negatives on the word lanes,
  // the tau and level filters on the last lane.
  bool neg = false;
  if (live && hit_any && !hit_exact && !seed_pos) {
    if (word)
      neg |= reach::seed_neg_word(static_cast<uint32_t>(sps),
                                  static_cast<uint32_t>(__ldg(sm + ws + g.r)),
                                  static_cast<uint32_t>(__ldg(sp + wt + g.r)),
                                  static_cast<uint32_t>(smt));
    if (g.r == lanes - 1)
      neg |= reach::naive_filters(__ldg(tau + s), __ldg(tau + t),
                                  __ldg(lvl + s), __ldg(lvl + t));
    for (int j = g.r + lanes; j < w; j += lanes)          // W > 32
      neg |= reach::seed_neg_word(static_cast<uint32_t>(__ldg(sp + ws + j)),
                                  static_cast<uint32_t>(__ldg(sm + ws + j)),
                                  static_cast<uint32_t>(__ldg(sp + wt + j)),
                                  static_cast<uint32_t>(__ldg(sm + wt + j)));
  }
  neg = g.any(neg);
  if (g.i < q && g.r == 0)
    out[g.i] = live ? reach::verdict_of(hit_any, hit_exact, seed_pos, neg)
                    : reach::POS;
}

// The launch shape of ``launch_shape`` and the vector width, as the kernels
// need them: V in {1, 2, 4} dividing K, lanes a power of two dividing 32,
// whole warps a block, and a thread for every lane of every query.
bool shape_ok(int64_t q, int k, int vec, int lanes, int threads,
              int64_t blocks) {
  return (vec == 1 || vec == 2 || vec == 4) && k >= 0 && k % vec == 0 &&
         lanes >= 1 && lanes <= 32 && 32 % lanes == 0 && threads >= 32 &&
         threads <= 1024 && threads % 32 == 0 && blocks >= 1 &&
         blocks <= INT_MAX && blocks * threads >= q * lanes;
}


template <bool Owned>
int launch_packed(const int32_t* meta, const int32_t* slab, const int32_t* cs,
                  const int32_t* ct, int32_t* out, int64_t q, int k, int vec,
                  int lanes, int threads, int64_t blocks, Rows rows,
                  cudaStream_t stream) {
  if (!shape_ok(q, k, vec, lanes, threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  if (lanes == 1)
    stab_packed_one<Owned><<<grid, threads, 0, stream>>>(meta, slab, cs, ct,
                                                         out, q, k, rows);
  else if (vec == 4)
    stab_packed_kernel<4, Owned><<<grid, threads, 0, stream>>>(
        meta, slab, cs, ct, out, q, k, lanes, rows);
  else if (vec == 2)
    stab_packed_kernel<2, Owned><<<grid, threads, 0, stream>>>(
        meta, slab, cs, ct, out, q, k, lanes, rows);
  else
    stab_packed_kernel<1, Owned><<<grid, threads, 0, stream>>>(
        meta, slab, cs, ct, out, q, k, lanes, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int reach_stab_packed(const int32_t* meta, const int32_t* slab,
                                 const int32_t* cs, const int32_t* ct,
                                 int32_t* out, int64_t q, int k, int vec,
                                 int lanes, int threads, int64_t blocks,
                                 cudaStream_t stream) {
  return launch_packed<false>(meta, slab, cs, ct, out, q, k, vec, lanes,
                              threads, blocks, Rows{nullptr, 0, 0}, stream);
}

// meta_t: [q, 4] t's exchanged meta rows by query position; meta, slab:
// this rank's n_loc rows from node id base on; out: 0 where the rank does
// not own the source.
extern "C" int reach_stab_packed_owned(const int32_t* meta_t,
                                       const int32_t* meta,
                                       const int32_t* slab, const int32_t* cs,
                                       const int32_t* ct, int32_t* out,
                                       int64_t q, int k, int vec, int lanes,
                                       int threads, int64_t blocks,
                                       int64_t base, int64_t n_loc,
                                       cudaStream_t stream) {
  if (base < 0 || n_loc < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_packed<true>(meta, slab, cs, ct, out, q, k, vec, lanes,
                             threads, blocks, Rows{meta_t, base, n_loc},
                             stream);
}

extern "C" int reach_stab_naive(const int32_t* pi, const int32_t* tau,
                                const int32_t* lvl, const int32_t* begins,
                                const int32_t* ends, const int32_t* exact,
                                const int32_t* sp, const int32_t* sm,
                                const int32_t* cs, const int32_t* ct,
                                int32_t* out, int64_t q, int k, int w,
                                int vec, int lanes, int threads,
                                int64_t blocks, cudaStream_t stream) {
  if (w < 0 || !shape_ok(q, k, vec, lanes, threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  if (vec == 4)
    stab_naive_kernel<4><<<grid, threads, 0, stream>>>(
        pi, tau, lvl, begins, ends, exact, sp, sm, cs, ct, out, q, k, w,
        lanes);
  else if (vec == 2)
    stab_naive_kernel<2><<<grid, threads, 0, stream>>>(
        pi, tau, lvl, begins, ends, exact, sp, sm, cs, ct, out, q, k, w,
        lanes);
  else
    stab_naive_kernel<1><<<grid, threads, 0, stream>>>(
        pi, tau, lvl, begins, ends, exact, sp, sm, cs, ct, out, q, k, w,
        lanes);
  return static_cast<int>(cudaGetLastError());
}
