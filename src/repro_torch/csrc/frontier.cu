// Sparse phase-2 BFS step on the card (kernels 3 and 4), with the loop
// control on the device.
//
// Kernel 3, expand_probe: replaces the Pallas kernel
//   src/repro/kernels/frontier_fused.py::_probe_kernel (:60, pallas_call
//   :101 through _row_call) together with the XLA work of its step around
//   it (:159-199): the ELL gather, the hub tail sweep gated by a frontier
//   bitset, and the prefix-sum compaction into cap + 1 slots.
// Kernel 4, dedup_classify_emit: replaces the Pallas kernel
//   src/repro/kernels/frontier_fused.py::_classify_emit_kernel (:78,
//   pallas_call :265 through _classify_call) together with the rest of the
//   step (:199-239): the sorted unique of the slots, the overflow rule, the
//   phase-1 packed verdict (verdict.cuh) with the s == t positive, the
//   answered flags, the visited marks and the next front. With a live
//   overlay it reads can_reach_tail in place and applies the union-graph
//   rule of expand_frontier_overlay_fused's post_verdict (:313): a NEG
//   survivor that can reach a delta tail stays UNKNOWN (overlay_verdict).
//
// The reference runs the step under lax.while_loop; here the loop is a CUDA
// graph whose while node runs {kernel 3, kernel 4} as long as kernel 4 sets
// its condition: one graph launch and one read-back a call, two launches a
// step, no host sync a step. A call is set-up (first front, visited bits of
// the sources), the while node, then clean-up, which zeroes the visited
// words the call set (from the keys it logged) and the frontier bitset's
// last words, so the engine keeps one zeroed bitset across calls. Each
// kernel counts its own launches in a control word (L_*), which the host
// reads back with the others, so a graph's launches are measured on the
// device.
//
// Kernel 3: persistent blocks take 1024-candidate tiles in order (an atomic
// tile counter). Candidate c < n_front * W is ELL slot c % W of front entry
// c / W; after those, when a hub is in the front, c = n_front * W + qi * m_t
// + e is tail edge e of query qi, live where the frontier bitset holds
// tail_src[e] for qi. Each reads its ELL row, visited word and answered
// flag in place (the reference gathers them into [cap * W] arrays first).
// Survivors are compacted in candidate order, the reference's order, by a
// single-pass scan with decoupled look-back (status words tagged by a step
// epoch, so they need no reset), into cap + 1 slots; the survivor count is
// kept, and decides overflow.
// Kernel 3's exchanged-rows entry (reach_expand_probe_rows) serves the
// sharded placement (core/distributed.py::expand_frontier_sharded): a
// rank holds only its shard of the ELL slab, so the front's rows arrive
// from the owned-rows exchange as an [n_front, W] buffer in front order,
// and ELL slot j of front entry i is rows[i * W + j]; the rest of the
// step (the tail sweep, the probe, the ordered compaction) is the same.
// Kernel 4 then runs as mark and emit on the verdicts of the exchange.
// Kernel 4: one block of 1024 threads. It sorts the live slots in shared
// memory (a rank a thread up to 1024 survivors, else bitonic; cap + 1 <=
// 16,385 keys: 128 KB and the uniques' 64 KB; at the phase-2 path's step
// of 368 survivors the rank sort measured ~1.3 us faster than bitonic
// alone, PERF.md §6), takes the unique keys, reads meta and slab rows in
// place, marks visited bits with atomicOr on live keys only (the keys are
// distinct and unseen, so this is the reference's uint32 add), and after a
// barrier emits the next front densely in sorted order, with its hub bits,
// and the control words; the answered queries and hub flags it needs then
// are in shared memory. Above 16,384 slots (and for the 12-array layout,
// whose verdict is kernel 2's and whose unique runs over every survivor)
// the unique is torch.sort's and kernel 4 runs as two launches: mark (many
// blocks) and emit (one block); the host then reads the control words once
// a step.
//
// Bound on an H100 (3.35 TB/s): the bytes a step must move depend on the
// data: kernel 3 reads each front key, its ELL row (4 W B), the visited
// word and answered flag of each valid candidate and writes each survivor;
// kernel 4 reads the survivors and, for each unique live key, two 16 B meta
// rows and an 8 K B slab row, and writes the front and a few words. At the
// phase-2 path's steps that is well under a microsecond of bytes, against
// microseconds a launch: the design cuts launches and host syncs (the
// per-step host round trip, the [cap * W] arrays, the index_put_ of the
// visited marks), not bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "verdict.cuh"

namespace {

constexpr int kThreads = 256;              // kernel 3's block
constexpr int kItems = 4;                  // candidates a thread a tile
constexpr int kTile = kThreads * kItems;   // candidates a tile
constexpr int kWarps = kThreads / 32;      // kItems * kWarps == 32
constexpr int kStepThreads = 1024;         // kernel 4's block
constexpr int kMaxBlocksPerSm = 8;

// Control words, then pos [q] in the same buffer.
// L_*: launch counters, one a kernel (kernel 4's two-launch form shares
// L_CLASSIFY); block 0's thread 0 adds one on entry, before the RUN test.
enum Ctl {
  RUN, N_FRONT, HUB, OVF, STEP, RAW, TILE, EPOCH, LOG_N, M_NEW,
  L_SETUP, L_PROBE, L_CLASSIFY, L_CLEANUP, CTL_WORDS = 16
};

// The int64 argument vector of every entry point (see frontier_fused.py's
// ARG_FIELDS, in the same order).
enum Arg {
  A_CTL, A_FRONT, A_SLOTS, A_STATUS, A_VISITED, A_FBITS, A_LOG, A_ELL,
  A_TSRC, A_TDST, A_IS_HUB, A_META, A_SLAB, A_CS, A_CT, A_PAD, A_UNIQ,
  A_VERDICT_IN, A_VERDICT, A_CRT, A_N_WORDS, A_SLOT_CAP, A_LOG_CAP, A_MAX_TILES,
  A_Q, A_W, A_M_T, A_K, A_CAP, A_VBITS, A_MAX_STEPS, A_ROWS, A_COUNT
};

struct Step {
  int32_t* ctl;
  int32_t* pos;
  int32_t* front;
  int32_t* slots;
  unsigned long long* status;
  int32_t* visited;
  int32_t* fbits;            // null without a COO tail
  int32_t* log;
  const int32_t* ell;
  const int32_t* tail_src;
  const int32_t* tail_dst;
  const uint8_t* is_hub;
  const int32_t* meta;       // null for the 12-array layout
  const int32_t* slab;
  const int32_t* cs;
  const int32_t* ct;
  const uint8_t* pad;
  const int32_t* uniq;       // mark: sorted unique keys [cap + 1]
  const int32_t* verdict_in;  // mark: kernel 2's verdicts [cap], or null
  int32_t* verdict;          // mark -> emit: verdicts [cap]
  const uint8_t* can_reach_tail;  // [n], the live overlay's; else null
  const int32_t* rows;       // the front's ELL rows [n_front, W], or null
  int64_t n_words, slot_cap, log_cap, max_tiles;
  int32_t q, w, m_t, k, cap, vbits, max_steps;
  cudaGraphConditionalHandle cond;   // 0 outside the graph
};

Step step_of(const int64_t* a) {
  Step s;
  s.ctl = reinterpret_cast<int32_t*>(a[A_CTL]);
  s.pos = s.ctl + CTL_WORDS;
  s.front = reinterpret_cast<int32_t*>(a[A_FRONT]);
  s.slots = reinterpret_cast<int32_t*>(a[A_SLOTS]);
  s.status = reinterpret_cast<unsigned long long*>(a[A_STATUS]);
  s.visited = reinterpret_cast<int32_t*>(a[A_VISITED]);
  s.fbits = reinterpret_cast<int32_t*>(a[A_FBITS]);
  s.log = reinterpret_cast<int32_t*>(a[A_LOG]);
  s.ell = reinterpret_cast<const int32_t*>(a[A_ELL]);
  s.tail_src = reinterpret_cast<const int32_t*>(a[A_TSRC]);
  s.tail_dst = reinterpret_cast<const int32_t*>(a[A_TDST]);
  s.is_hub = reinterpret_cast<const uint8_t*>(a[A_IS_HUB]);
  s.meta = reinterpret_cast<const int32_t*>(a[A_META]);
  s.slab = reinterpret_cast<const int32_t*>(a[A_SLAB]);
  s.cs = reinterpret_cast<const int32_t*>(a[A_CS]);
  s.ct = reinterpret_cast<const int32_t*>(a[A_CT]);
  s.pad = reinterpret_cast<const uint8_t*>(a[A_PAD]);
  s.uniq = reinterpret_cast<const int32_t*>(a[A_UNIQ]);
  s.verdict_in = reinterpret_cast<const int32_t*>(a[A_VERDICT_IN]);
  s.verdict = reinterpret_cast<int32_t*>(a[A_VERDICT]);
  s.can_reach_tail = reinterpret_cast<const uint8_t*>(a[A_CRT]);
  s.rows = reinterpret_cast<const int32_t*>(a[A_ROWS]);
  s.n_words = a[A_N_WORDS];
  s.slot_cap = a[A_SLOT_CAP];
  s.log_cap = a[A_LOG_CAP];
  s.max_tiles = a[A_MAX_TILES];
  s.q = static_cast<int32_t>(a[A_Q]);
  s.w = static_cast<int32_t>(a[A_W]);
  s.m_t = static_cast<int32_t>(a[A_M_T]);
  s.k = static_cast<int32_t>(a[A_K]);
  s.cap = static_cast<int32_t>(a[A_CAP]);
  s.vbits = static_cast<int32_t>(a[A_VBITS]);
  s.max_steps = static_cast<int32_t>(a[A_MAX_STEPS]);
  s.cond = 0;
  return s;
}

__device__ __forceinline__ uint32_t bit_of(int32_t v) {
  return 1u << (static_cast<uint32_t>(v) & 31u);
}

__device__ __forceinline__ int64_t word_of(const Step& s, int32_t q,
                                           int32_t v) {
  return static_cast<int64_t>(q) * s.n_words + (v >> 5);
}

__device__ __forceinline__ void count_launch(const Step& s, int word) {
  if (blockIdx.x == 0 && threadIdx.x == 0) s.ctl[word] += 1;
}

__device__ __forceinline__ void set_condition(const Step& s, bool run) {
  if (s.cond) cudaGraphSetConditional(s.cond, run ? 1u : 0u);
}

// Exclusive scan of one flag a thread over a block of kStepThreads (32
// warps); returns the thread's offset and the block's total in *total.
// Three barriers; every thread of the block must call it.
__device__ __forceinline__ int block_scan(bool flag, int* total) {
  __shared__ int warp_off[32];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(~0u, flag);
  if (lane == 0) warp_off[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int x = warp_off[lane];
    int inc = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(~0u, inc, d);
      if (lane >= d) inc += y;
    }
    warp_off[lane] = inc - x;
    if (lane == 31) block_total = inc;
  }
  __syncthreads();
  const int off = warp_off[warp] + __popc(m & ((1u << lane) - 1u));
  *total = block_total;
  __syncthreads();
  return off;
}

// ------------------------------------------------------------- set-up
// One block. The first front (non-padded queries in order), visited bits of
// the sources, their hub bits, the log, pos zeroed, the control words.
__global__ void __launch_bounds__(kStepThreads) setup_kernel(Step s) {
  __shared__ int n_live;
  count_launch(s, L_SETUP);
  if (threadIdx.x == 0) n_live = 0;
  for (int i = threadIdx.x; i < s.q; i += blockDim.x) s.pos[i] = 0;
  __syncthreads();
  bool hub = false;
  for (int base = 0; base < s.q; base += blockDim.x) {
    const int qi = base + threadIdx.x;
    const bool live = qi < s.q && s.pad[qi] == 0;
    int total;
    const int off = block_scan(live, &total);
    if (live) {
      const int32_t v = s.cs[qi];
      const int32_t key = (qi << s.vbits) | v;
      s.front[n_live + off] = key;
      s.log[n_live + off] = key;
      atomicOr(reinterpret_cast<unsigned*>(s.visited + word_of(s, qi, v)),
               bit_of(v));
      if (s.fbits && s.is_hub[v]) {
        atomicOr(reinterpret_cast<unsigned*>(s.fbits + word_of(s, qi, v)),
                 bit_of(v));
        hub = true;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) n_live += total;
    __syncthreads();
  }
  hub = __syncthreads_or(hub);
  if (threadIdx.x == 0) {
    const bool run = n_live > 0 && s.max_steps > 0;
    s.ctl[RUN] = run;
    s.ctl[N_FRONT] = n_live;
    s.ctl[HUB] = hub;
    s.ctl[OVF] = 0;
    s.ctl[STEP] = 0;
    s.ctl[RAW] = 0;
    s.ctl[TILE] = 0;
    s.ctl[EPOCH] += 1;
    s.ctl[LOG_N] = n_live;
    s.ctl[M_NEW] = 0;
    set_condition(s, run);
  }
}

// ------------------------------------------------------------ kernel 3
__device__ __forceinline__ int32_t candidate_key(const Step& s, int64_t c,
                                                 int64_t n_ell,
                                                 int64_t n_cand) {
  if (c >= n_cand) return reach::SENTINEL;
  const int32_t vmask = (1 << s.vbits) - 1;
  int32_t q, v;
  if (c < n_ell) {
    const int64_t i = c / s.w;
    const int j = static_cast<int>(c - i * s.w);
    const int32_t f = __ldg(s.front + i);
    if (f == reach::SENTINEL) return reach::SENTINEL;
    q = f >> s.vbits;
    // the ELL row by node id, or the exchanged row by front position
    const int64_t r = s.rows ? i : static_cast<int64_t>(f & vmask);
    v = __ldg((s.rows ? s.rows : s.ell) + r * s.w + j);
    if (v < 0) return reach::SENTINEL;
  } else {
    const int64_t t = c - n_ell;
    q = static_cast<int32_t>(t / s.m_t);
    const int e = static_cast<int>(t - static_cast<int64_t>(q) * s.m_t);
    const int32_t src = __ldg(s.tail_src + e);
    const auto gate = static_cast<uint32_t>(__ldg(s.fbits + word_of(s, q, src)));
    if ((gate & bit_of(src)) == 0u) return reach::SENTINEL;
    v = __ldg(s.tail_dst + e);
  }
  const auto word = static_cast<uint32_t>(__ldg(s.visited + word_of(s, q, v)));
  if ((word & bit_of(v)) != 0u || __ldg(s.pos + q) != 0) return reach::SENTINEL;
  return (q << s.vbits) | v;
}

constexpr unsigned long long kAggregate = 1ull << 30;
constexpr unsigned long long kPrefix = 2ull << 30;
constexpr unsigned long long kValue = (1ull << 30) - 1;

// Publishes a tile's survivor count and returns the survivors of the tiles
// before it (decoupled look-back; one thread).
__device__ int look_back(const Step& s, int64_t tile, uint32_t epoch,
                         int count) {
  const unsigned long long tag = static_cast<unsigned long long>(epoch) << 32;
  unsigned long long* st = s.status;
  if (tile == 0) {
    atomicExch(st, tag | kPrefix | static_cast<unsigned long long>(count));
    return 0;
  }
  atomicExch(st + tile, tag | kAggregate | static_cast<unsigned long long>(count));
  int excl = 0;
  for (int64_t p = tile - 1;;) {
    const unsigned long long w =
        *reinterpret_cast<volatile unsigned long long*>(st + p);
    if ((w >> 32) != epoch || (w & (kAggregate | kPrefix)) == 0) continue;
    excl += static_cast<int>(w & kValue);
    if (w & kPrefix) break;
    --p;
  }
  atomicExch(st + tile,
             tag | kPrefix | static_cast<unsigned long long>(excl + count));
  return excl;
}

__global__ void __launch_bounds__(kThreads) expand_probe_kernel(Step s) {
  __shared__ int64_t tile_sh;
  __shared__ int part[kItems * kWarps];
  __shared__ int base_sh, total_sh;
  count_launch(s, L_PROBE);
  if (s.ctl[RUN] == 0) return;
  const int32_t n_front = s.ctl[N_FRONT];
  const bool hub = s.ctl[HUB] != 0 && s.fbits != nullptr;
  const auto epoch = static_cast<uint32_t>(s.ctl[EPOCH]);
  const int64_t n_ell = static_cast<int64_t>(n_front) * s.w;
  const int64_t n_cand =
      n_ell + (hub ? static_cast<int64_t>(s.q) * s.m_t : 0);
  const int64_t n_tiles = (n_cand + kTile - 1) / kTile;
  // block b takes tile b, then (when the step has more tiles than the
  // grid) tiles in order from the tile counter; the grid's blocks are all
  // resident at once (probe_grid), so a tile's look-back always finds its
  // predecessor's block running
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t tile = blockIdx.x;;) {
    if (tile >= n_tiles) return;
    int32_t key[kItems];
    int rank[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      key[it] = candidate_key(s, tile * kTile + it * kThreads + threadIdx.x,
                              n_ell, n_cand);
      const unsigned m = __ballot_sync(~0u, key[it] != reach::SENTINEL);
      rank[it] = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) part[it * kWarps + warp] = __popc(m);
    }
    __syncthreads();
    if (warp == 0) {
      // the 32 partial counts in candidate order: item-major, then warp
      const int x = part[lane];
      int inc = x;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(~0u, inc, d);
        if (lane >= d) inc += y;
      }
      const int total = __shfl_sync(~0u, inc, 31);
      part[lane] = inc - x;
      if (lane == 0) {
        base_sh = look_back(s, tile, epoch, total);
        total_sh = total;
      }
    }
    __syncthreads();
    const int64_t base = base_sh;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (key[it] == reach::SENTINEL) continue;
      const int64_t slot = base + part[it * kWarps + warp] + rank[it];
      if (slot < s.slot_cap) s.slots[slot] = key[it];
    }
    if (tile == n_tiles - 1 && threadIdx.x == 0)
      s.ctl[RAW] = static_cast<int32_t>(base + total_sh);
    if (n_tiles <= gridDim.x) return;
    if (threadIdx.x == 0) tile_sh = gridDim.x + atomicAdd(s.ctl + TILE, 1);
    __syncthreads();
    tile = tile_sh;
  }
}

// ------------------------------------------------------------ kernel 4
__device__ __forceinline__ int verdict_of_key(const Step& s, int32_t key) {
  const int32_t vmask = (1 << s.vbits) - 1;
  const int32_t nq = key >> s.vbits, nv = key & vmask;
  const int32_t nt = __ldg(s.ct + nq);
  if (nv == nt) return reach::POS;
  return reach::packed_verdict(reach::load_row4(s.meta, nv),
                               reach::load_row4(s.meta, nt),
                               s.slab + static_cast<int64_t>(nv) * 2 * s.k,
                               s.k);
}

// The live overlay's rule (union-graph serving, reach/dynamic): a NEG
// survivor that can still reach a delta edge's tail stays UNKNOWN and
// keeps expanding; POS and UNKNOWN are unchanged. Every verdict kernel 4
// takes, its own (verdict_of_key) or kernel 2's (verdict_in), passes here.
__device__ __forceinline__ int overlay_verdict(const Step& s, int32_t nv,
                                               int v) {
  return v == reach::NEG && s.can_reach_tail && s.can_reach_tail[nv]
             ? reach::UNKNOWN
             : v;
}

// Verdict words carry the key's hub flag above the verdict, so the emit
// reads no table.
constexpr int kHubFlag = 16;

// The answered flag and visited bit of a live unique key, and its verdict
// word.
__device__ __forceinline__ int mark(const Step& s, int32_t key, int v) {
  const int32_t vmask = (1 << s.vbits) - 1;
  const int32_t nq = key >> s.vbits, nv = key & vmask;
  if (v == reach::POS) s.pos[nq] = 1;
  atomicOr(reinterpret_cast<unsigned*>(s.visited + word_of(s, nq, nv)),
           bit_of(nv));
  return v | (s.fbits && s.is_hub[nv] ? kHubFlag : 0);
}

// Clears the hub bits of the front kernel 3 read (strided over a grid).
// The next front's bits differ from these, so the emit may set them in
// any order with this.
__device__ __forceinline__ void clear_front_bits(const Step& s, int n_front,
                                                 int64_t i0, int64_t stride) {
  if (!s.fbits) return;
  const int32_t vmask = (1 << s.vbits) - 1;
  for (int64_t i = i0; i < n_front; i += stride) {
    const int32_t f = s.front[i];
    if (f == reach::SENTINEL) continue;
    const int32_t fq = f >> s.vbits, fv = f & vmask;
    if (s.is_hub[fv])
      atomicAnd(reinterpret_cast<unsigned*>(s.fbits + word_of(s, fq, fv)),
                ~bit_of(fv));
  }
}

// The next front from the m unique keys (uniq) and their verdict words
// (verd), densely in order, its hub bits, and the control words. One
// block. A query answered in this step drops its keys: ``answered`` (a
// bitmap of this step's POS queries in shared memory) where given, else
// pos, which a launch before wrote (a query answered in an earlier step
// has no key left: kernel 3 drops them).
__device__ void emit_front(const Step& s, const int32_t* uniq,
                           const int32_t* verd, int m, bool ovf,
                           const uint32_t* answered) {
  __shared__ int n_new;
  if (threadIdx.x == 0) n_new = 0;
  __syncthreads();
  bool hub = false;
  for (int base = 0; base < m; base += blockDim.x) {
    const int k = base + threadIdx.x;
    bool keep = false;
    int32_t key = reach::SENTINEL;
    int v = 0;
    if (k < m) {
      key = uniq[k];
      v = verd[k];
      const int32_t nq = key >> s.vbits;
      const bool done = answered
                            ? (answered[nq >> 5] & bit_of(nq)) != 0u
                            : s.pos[nq] != 0;
      keep = (v & 3) == reach::UNKNOWN && !done;
    }
    int total;
    const int off = block_scan(keep, &total);
    if (keep) {
      s.front[n_new + off] = key;
      if (v & kHubFlag) {
        const int32_t nv = key & ((1 << s.vbits) - 1);
        atomicOr(reinterpret_cast<unsigned*>(
                     s.fbits + word_of(s, key >> s.vbits, nv)),
                 bit_of(nv));
        hub = true;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) n_new += total;
    __syncthreads();
  }
  hub = __syncthreads_or(hub);
  if (threadIdx.x == 0) {
    const int step = s.ctl[STEP] + 1;
    const bool run = n_new > 0 && !ovf && step < s.max_steps;
    s.ctl[RUN] = run;
    s.ctl[N_FRONT] = n_new;
    s.ctl[HUB] = hub;
    s.ctl[OVF] = ovf;
    s.ctl[STEP] = step;
    s.ctl[RAW] = 0;
    s.ctl[TILE] = 0;
    s.ctl[EPOCH] += 1;
    s.ctl[LOG_N] += m;
    s.ctl[M_NEW] = 0;
    set_condition(s, run);
  }
}

// One block: sort + unique of the live slots in shared memory, classify,
// mark, emit. Shared memory: keys [p_max], uniques [cap + 1], then the
// bitmap of this step's answered queries [ceil(q / 32)].
__global__ void __launch_bounds__(kStepThreads)
    dedup_classify_emit_kernel(Step s, int p_max) {
  extern __shared__ int32_t smem[];
  __shared__ int u_sh;
  count_launch(s, L_CLASSIFY);
  if (s.ctl[RUN] == 0) return;
  int32_t* keys = smem;
  int32_t* uniq = smem + p_max;
  auto* answered = reinterpret_cast<uint32_t*>(uniq + s.cap + 1);
  const int raw = s.ctl[RAW];
  const int n = min(raw, s.cap + 1);
  const int n_front = s.ctl[N_FRONT];
  const int log_n = s.ctl[LOG_N];
  const bool ovf_in = s.ctl[OVF] != 0;
  // the old front's hub bits first: their loads overlap the sort's
  clear_front_bits(s, n_front, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < (s.q + 31) / 32; i += blockDim.x)
    answered[i] = 0u;
  if (threadIdx.x == 0) u_sh = 0;
  if (n <= static_cast<int>(blockDim.x)) {
    // one key a thread: its rank among the n by (key, slot), from the
    // keys staged in the uniques' space (written only after the sort)
    const int i = threadIdx.x;
    const int32_t key = i < n ? s.slots[i] : reach::SENTINEL;
    if (i < n) uniq[i] = key;
    __syncthreads();
    if (i < n) {
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const int32_t other = uniq[j];
        rank += other < key || (other == key && j < i);
      }
      keys[rank] = key;
    }
  } else {
    int p = 1;
    while (p < n) p <<= 1;
    for (int i = threadIdx.x; i < p; i += blockDim.x)
      keys[i] = i < n ? s.slots[i] : reach::SENTINEL;
    __syncthreads();
    for (int kk = 2; kk <= p; kk <<= 1) {        // bitonic sort, ascending
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p; i += blockDim.x) {
          const int ij = i ^ j;
          if (ij > i) {
            const int32_t a = keys[i], b = keys[ij];
            if ((a > b) == ((i & kk) == 0)) { keys[i] = b; keys[ij] = a; }
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {   // unique, in order
    const int i = base + threadIdx.x;
    const bool first = i < n && (i == 0 || keys[i] != keys[i - 1]);
    int total;
    const int off = block_scan(first, &total);
    const int u = u_sh;
    if (first && u + off <= s.cap) uniq[u + off] = keys[i];
    __syncthreads();
    if (threadIdx.x == 0) u_sh = u + total;
    __syncthreads();
  }
  const int u = u_sh;
  const bool ovf = ovf_in || raw > s.cap + 1 || u > s.cap;
  const int m = min(u, s.cap);
  int32_t* verd = keys;                      // the sorted keys are done
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const int32_t key = uniq[k];
    const int v = overlay_verdict(s, key & ((1 << s.vbits) - 1),
                                  verdict_of_key(s, key));
    if (v == reach::POS) {
      const int32_t nq = key >> s.vbits;
      atomicOr(answered + (nq >> 5), bit_of(nq));
    }
    verd[k] = mark(s, key, v);
    if (log_n + k < s.log_cap) s.log[log_n + k] = key;
  }
  __syncthreads();
  emit_front(s, uniq, verd, m, ovf, answered);
}

// Kernel 4 above one block's sort: the uniques come from torch.sort. Many
// blocks: verdict (kernel 4's own, or kernel 2's in verdict_in), answered
// flags, visited marks, log; the count of live uniques into M_NEW; the
// front's hub bits cleared.
__global__ void __launch_bounds__(kThreads) mark_kernel(Step s, int keep_all) {
  count_launch(s, L_CLASSIFY);
  if (s.ctl[RUN] == 0) return;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int log_n = s.ctl[LOG_N];
  clear_front_bits(s, s.ctl[N_FRONT], i0, stride);
  for (int64_t k = i0; k < s.cap; k += stride) {
    const int32_t key = s.uniq[k];
    if (key == reach::SENTINEL) continue;
    const int v = overlay_verdict(
        s, key & ((1 << s.vbits) - 1),
        s.verdict_in ? s.verdict_in[k] : verdict_of_key(s, key));
    s.verdict[k] = mark(s, key, v);
    if (log_n + k < s.log_cap) s.log[log_n + k] = key;
    if (k == s.cap - 1 || s.uniq[k + 1] == reach::SENTINEL)
      s.ctl[M_NEW] = static_cast<int32_t>(k + 1);   // one thread: the last
  }
  if (i0 == 0) {
    const bool ovf = s.ctl[OVF] != 0 ||
                     (!keep_all && s.ctl[RAW] > s.cap + 1) ||
                     s.uniq[s.cap] != reach::SENTINEL;
    s.ctl[OVF] = ovf;
  }
}

// The emit after mark_kernel: one block.
__global__ void __launch_bounds__(kStepThreads) emit_kernel(Step s) {
  count_launch(s, L_CLASSIFY);
  if (s.ctl[RUN] == 0) return;
  emit_front(s, s.uniq, s.verdict, s.ctl[M_NEW], s.ctl[OVF] != 0,
             nullptr);
}

// ------------------------------------------------------------- clean-up
// Zeroes the visited words of every logged key (the whole bitset when the
// call marked more keys than the log holds) and the hub-bit words of the
// last front, so the bitsets are zero for the next call.
__global__ void __launch_bounds__(kThreads) cleanup_kernel(Step s) {
  count_launch(s, L_CLEANUP);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int32_t vmask = (1 << s.vbits) - 1;
  const int64_t log_n = s.ctl[LOG_N];
  if (log_n > s.log_cap) {
    for (int64_t i = i0; i < s.q * s.n_words; i += stride) s.visited[i] = 0;
  } else {
    for (int64_t i = i0; i < log_n; i += stride) {
      const int32_t key = s.log[i];
      s.visited[word_of(s, key >> s.vbits, key & vmask)] = 0;
    }
  }
  if (s.fbits) {
    const int n_front = s.ctl[N_FRONT];
    for (int64_t i = i0; i < n_front; i += stride) {
      const int32_t f = s.front[i];
      if (f != reach::SENTINEL)
        s.fbits[word_of(s, f >> s.vbits, f & vmask)] = 0;
    }
  }
}

int g_sms = 0;

int sm_count() {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return g_sms;
}

int g_probe_blocks = 0;

// Kernel 3's grid: at most as many blocks as the card holds at once.
unsigned probe_grid(const Step& s) {
  if (g_probe_blocks == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_probe_kernel,
                                                  kThreads, 0);
    g_probe_blocks = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t g = s.max_tiles < g_probe_blocks ? s.max_tiles
                                                 : g_probe_blocks;
  return static_cast<unsigned>(g > 0 ? g : 1);
}

unsigned cleanup_grid(const Step& s) {
  const int64_t limit = static_cast<int64_t>(sm_count()) * kMaxBlocksPerSm;
  const int64_t want = (s.log_cap + kThreads - 1) / kThreads;
  const int64_t g = want < limit ? want : limit;
  return static_cast<unsigned>(g > 0 ? g : 1);
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Kernel 4's one-block shared memory, after opting in to it.
int step_smem(const Step& s, int* p_max) {
  *p_max = pow2_at_least(s.cap + 1);
  const int bytes = (*p_max + s.cap + 1 + (s.q + 31) / 32) * 4;
  cudaFuncSetAttribute(dedup_classify_emit_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return bytes;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph,
                       const cudaGraphNode_t* dep, void* func, unsigned grid,
                       unsigned block, unsigned smem, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(grid);
  p.blockDim = dim3(block);
  p.sharedMemBytes = smem;
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

}  // namespace

extern "C" int reach_frontier_setup(const int64_t* a, cudaStream_t stream) {
  const Step s = step_of(a);
  setup_kernel<<<1, kStepThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_expand_probe(const int64_t* a, cudaStream_t stream) {
  const Step s = step_of(a);
  expand_probe_kernel<<<probe_grid(s), kThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3 on the front's exchanged ELL rows (A_ROWS, [n_front, W]).
extern "C" int reach_expand_probe_rows(const int64_t* a, cudaStream_t stream) {
  const Step s = step_of(a);
  if (s.rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  expand_probe_kernel<<<probe_grid(s), kThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_dedup_classify_emit(const int64_t* a,
                                         cudaStream_t stream) {
  const Step s = step_of(a);
  int p_max;
  const int smem = step_smem(s, &p_max);
  dedup_classify_emit_kernel<<<1, kStepThreads, smem, stream>>>(s, p_max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_frontier_mark(const int64_t* a, int keep_all,
                                   cudaStream_t stream) {
  const Step s = step_of(a);
  const int64_t limit = static_cast<int64_t>(sm_count()) * kMaxBlocksPerSm;
  const int64_t want = (s.cap + kThreads - 1) / kThreads;
  mark_kernel<<<static_cast<unsigned>(want < limit ? want : limit), kThreads,
                0, stream>>>(s, keep_all);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_frontier_emit(const int64_t* a, cudaStream_t stream) {
  const Step s = step_of(a);
  emit_kernel<<<1, kStepThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reach_frontier_cleanup(const int64_t* a, cudaStream_t stream) {
  const Step s = step_of(a);
  cleanup_kernel<<<cleanup_grid(s), kThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// One expansion call as a graph: set-up, a while node over {kernel 3,
// kernel 4} whose condition kernel 4 (and set-up) set, then clean-up.
// Writes the executable graph's handle to *out.
extern "C" int reach_frontier_graph(const int64_t* a, int64_t* out) {
  Step s = step_of(a);
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle cond;
  cudaGraphNode_t setup, loop, probe, step, cleanup;
  int p_max;
  const int smem = step_smem(s, &p_max);
  void* args[] = {&s};
  void* step_args[] = {&s, &p_max};
  err = cudaGraphConditionalHandleCreate(&cond, graph, 0, 0);
  if (err == cudaSuccess) {
    s.cond = cond;
    err = add_kernel(&setup, graph, nullptr,
                     reinterpret_cast<void*>(setup_kernel), 1, kStepThreads,
                     0, args);
  }
  cudaGraphNodeParams params = {};
  if (err == cudaSuccess) {
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = cond;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    err = cudaGraphAddNode(&loop, graph, &setup, 1, &params);
  }
  if (err == cudaSuccess) {
    cudaGraph_t body = params.conditional.phGraph_out[0];
    err = add_kernel(&probe, body, nullptr,
                     reinterpret_cast<void*>(expand_probe_kernel),
                     probe_grid(s), kThreads, 0, args);
    if (err == cudaSuccess)
      err = add_kernel(&step, body, &probe,
                       reinterpret_cast<void*>(dedup_classify_emit_kernel), 1,
                       kStepThreads, smem, step_args);
  }
  if (err == cudaSuccess)
    err = add_kernel(&cleanup, graph, &loop,
                     reinterpret_cast<void*>(cleanup_kernel), cleanup_grid(s),
                     kThreads, 0, args);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err == cudaSuccess) *out = reinterpret_cast<int64_t>(exec);
  return static_cast<int>(err);
}

extern "C" int reach_frontier_graph_launch(int64_t exec, cudaStream_t stream) {
  return static_cast<int>(
      cudaGraphLaunch(reinterpret_cast<cudaGraphExec_t>(exec), stream));
}

extern "C" int reach_frontier_graph_destroy(int64_t exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(reinterpret_cast<cudaGraphExec_t>(exec)));
}
