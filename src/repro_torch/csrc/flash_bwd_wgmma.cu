// Flash attention backward on the tensor cores: dq (kernel 7) and dk, dv
// (kernel 8), bfloat16.
//
// Replace the two Pallas calls of
//   src/repro/kernels/flash_attention.py::_flash_vjp_bwd
//   (bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel) for bfloat16
//   q, do [B, Sq, H, HD] and k, v [B, Sk, KV, HD], H = KV·G, HD 64 or 128,
//   the forward's lse and delta = Σ_hd do·out (both [B, H, Sq] float32):
//     P   = exp(q·kᵀ·scale − lse), masked lanes set to 0 by a select
//     dP  = do·vᵀ,  dS = P ∘ (dP − delta)
//     dq  = scale · dS·k,  dk = scale · Σ_g dSᵀ·q,  dv = Σ_g Pᵀ·do
//   with the TPU kernels' roundings: P to bf16 before Pᵀ·do, dS to bf16
//   before dS·k and dSᵀ·q, float32 sums. Query head h reads kv head h / G
//   in place (the reference's [KV, G] grouping; its TPU kernels take the
//   heads expanded), and dk, dv [B, Sk, KV, HD] are the float32 sums over
//   the G query heads of each kv head, rounded once. The masks are keys ≥
//   Sk, query rows ≥ Sq and, when causal, q_offset + row < key. float32
//   calls stay on the FMA kernels in flash_attention_bwd.cu.
//
// Bound on an H100: every unmasked (q, k) pair costs 6·HD flops in kernel 7
// (q·k, do·v, dS·k) and 8·HD in kernel 8 (q·k, do·v, Pᵀ·do, dSᵀ·q); at
// tinyllama-1.1b's training call (B 4, S 4096, H 32, KV 4, HD 64, causal)
// 412 and 550 GFLOP: 0.42 and 0.56 ms at the bf16 tensor-core peak (989
// TFLOP/s) against ~0.1 ms of memory: bound by operations.
//
// Design (after FlashAttention-3's backward, as two kernels without
// atomics, so the gradients are the same bits from run to run): one block
// of three warpgroups. Warpgroup 0 is the producer: one thread loads the
// block's own tiles once and then streams tiles of T rows (T = 128 at HD
// 64, 64 at HD 128) with TMA into a two-stage ring, 128-byte swizzled,
// each stage guarded by a "full" mbarrier (TMA bytes arrived) and an
// "empty" one (both consumers done with it). It gives its registers away
// (setmaxnreg 24). Warpgroups 1 and 2 are consumers (setmaxnreg 240) that
// own 64 of the block's 128 rows each and, for every streamed tile, run
//   two SS products on the tensor cores (both operands K-major in shared
//   memory), issued together; the exponentials of the first overlap the
//   second; then the scores' fragment becomes P and dS in registers,
//   rounded to bf16 in place as the A operand of the RS products that
//   accumulate the gradient (B from shared memory MN-major, the transpose
//   bit: no tile is transposed or stored).
// Kernel 7 (dq): one block per (128-row q tile, b, h), heaviest first, the
//   G heads of a kv head next to each other so their K, V tiles meet in
//   L2. Q and dO load once; K and V tiles of kv head h / G stream up to the
//   diagonal. S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K (K the MN-major B).
//   A thread's two rows keep their lse and delta in registers.
// Kernel 8 (dk, dv): one block per (128-key tile, b, kv head), the first
//   key tiles (which see the most rows) first. K and V load once; Q, dO
//   and their lse, delta slices stream for each of the G query heads, from
//   the diagonal's q tile to Sq. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then dV +=
//   Pᵀ·dO and dK += dSᵀ·Q (dO and Q the MN-major B). lse and delta index
//   the fragment's columns, so they arrive per tile in shared memory: a
//   second producer warp copies them (a head's slice starts at any float,
//   where a TMA box would need 16-byte alignment) and arrives on the
//   stage's full barrier beside the TMA bytes. dK and dV stay in registers
//   across all G heads, in a fixed order, and are written once.
// Rows past Sq and keys past Sk arrive from TMA as zeros; where a tile
// crosses Sq, Sk or the causal diagonal its lanes are masked by a select
// (rows past Sq are columns of kernel 8, where lse is not theirs). Rows and
// keys past the ends are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_bwd_args.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kRows = 128;       // the block's own rows, 64 a consumer
constexpr int kStages = 2;
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBars = 1 + 2 * kStages;   // own tiles; full, empty a stage
constexpr int kWarp = 32;

// rows of a streamed tile: K, V (kernel 7) or Q, dO (kernel 8)
__host__ __device__ constexpr int tile_of(int hd) {
  return hd == 64 ? 128 : 64;
}

// A score accumulator's registers set to 0 before its product: the first
// k-slice overwrites them (scale_d 0), but the MMA's asm reads them, so
// without this the last tile's scores would stay live across the loop.
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int HD>
struct DqLayout {
  static constexpr int T = tile_of(HD);
  static constexpr int kQ = kRows * HD * 2;    // the Q or the dO tile
  static constexpr int kKV = T * HD * 2;       // one K or V tile
  static constexpr int kBytes = 2 * kQ + 2 * kStages * kKV;
  static constexpr int kAlloc = kBytes + 1024;   // room to align to 1 KB
};

template <int HD>
struct DkvLayout {
  static constexpr int T = tile_of(HD);
  static constexpr int kKV = kRows * HD * 2;   // the K or the V tile
  static constexpr int kQ = T * HD * 2;        // one Q or dO tile
  static constexpr int kStat = T * 4;          // one lse or delta slice
  static constexpr int kBytes = 2 * kKV + kStages * (2 * kQ + 2 * kStat);
  static constexpr int kAlloc = kBytes + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int batch,
                              int heads, int group, int sq, int sk,
                              int causal, int64_t q_offset, float scale) {
  using L = DqLayout<HD>;
  constexpr int T = L::T;
  constexpr int kPanelQ = kRows * 128;   // bytes of a [128, 64] panel
  constexpr int kPanelK = T * 128;       // bytes of a [T, 64] panel
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kQ;
  const uint32_t k_s = base + 2 * L::kQ;             // + stage · kKV
  const uint32_t v_s = k_s + kStages * L::kKV;
  const uint32_t own_full = smem_u32(&bars[0]);
  const uint32_t full = own_full + 8, empty = full + 8 * kStages;

  int idx = blockIdx.x;
  const int h = idx % heads;
  idx /= heads;
  const int b = idx % batch;
  const int nq = (sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - idx / batch) * kRows;     // heaviest first
  // keys the block's last valid row may see
  int64_t k_end = sk;
  if (causal) {
    const int64_t last = q_offset + min(q0 + kRows, sq);
    if (last < k_end) k_end = last;
  }
  const int n_tiles = static_cast<int>((k_end + T - 1) / T);

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer --
    regs_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(own_full, 2 * L::kQ);
#pragma unroll
      for (int p = 0; p < HD / 64; ++p) {
        tma_load_4d(q_s + p * kPanelQ, &tm_q, own_full, 64 * p, h, q0, b);
        tma_load_4d(do_s + p * kPanelQ, &tm_do, own_full, 64 * p, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p) {
          tma_load_4d(k_s + s * L::kKV + p * kPanelK, &tm_k, full + 8 * s,
                      64 * p, kvh, j * T, b);
          tma_load_4d(v_s + s * L::kKV + p * kPanelK, &tm_v, full + 8 * s,
                      64 * p, kvh, j * T, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumer --
    regs_inc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;      // and row + 8
    const int col = 2 * (lane % 4);                // and col + 1, + 8·j
    const int r0 = q0 + 64 * cw + row;
    // absolute position of the warpgroup's first row
    const int64_t qa0 = q_offset + q0 + 64 * cw;
    const uint32_t q_wg = q_s + cw * 64 * 128, do_wg = do_s + cw * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = r0 + 8 * r;
      const int64_t at = (static_cast<int64_t>(b) * heads + h) * sq + qr;
      lse2[r] = qr < sq ? lse[at] * kLog2e : 0.f;
      dlt[r] = qr < sq ? delta[at] : 0.f;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[T / 2], dp[T / 2];   // S then P; dP
    uint32_t ds[T / 16][4];       // dS in bf16, the A operand of dS·K

    mbar_wait(own_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t k_tile = k_s + s * L::kKV, v_tile = v_s + s * L::kKV;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      // S = Q·Kᵀ and dP = dO·Vᵀ: HD/16 k-slices each (32 bytes of a
      // 128-byte row), two commit groups
      zero(sc);
      zero(dp);
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kPanelQ + (kk % 4) * 32;
        wgmma_ss<T>(sc, desc_sw128(q_wg + off, 16, 1024),
                    desc_sw128(k_tile + (kk / 4) * kPanelK + (kk % 4) * 32,
                               16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kPanelQ + (kk % 4) * 32;
        wgmma_ss<T>(dp, desc_sw128(do_wg + off, 16, 1024),
                    desc_sw128(v_tile + (kk / 4) * kPanelK + (kk % 4) * 32,
                               16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();              // S is in; dP runs on
      fence_regs(sc);
      const int k0 = j * T;
      const bool edge = k0 + T > sk || (causal && k0 + T - 1 > qa0);
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[(i / 2) % 2]));
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + col + (i % 2);
          const int64_t qpos = qa0 + row + 8 * ((i / 2) % 2);
          if (kpos >= sk || (causal && qpos < kpos)) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < T / 2; i += 2) {
        const float d = dlt[(i / 2) % 2];
        ds[i / 8][(i % 8) / 2] =
            pack_bf16(sc[i] * (dp[i] - d), sc[i + 1] * (dp[i + 1] - d));
      }
      // dQ += dS·K: T/16 k-slices of 16 keys (2 KB of K rows)
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs<HD>(acc, ds[kk],
                     desc_sw128(k_tile + kk * 16 * 128, kPanelK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = r0 + 8 * r;
      if (qr >= sq) continue;
      __nv_bfloat16* dst =
          dq + ((static_cast<int64_t>(b) * sq + qr) * heads + h) * HD + col;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) = pack_bf16(
            acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int batch,
                               int heads, int kv_heads, int sq, int sk,
                               int causal, int64_t q_offset, float scale) {
  using L = DkvLayout<HD>;
  constexpr int T = L::T;
  constexpr int kPanelK = kRows * 128;   // bytes of a [128, 64] panel
  constexpr int kPanelQ = T * 128;       // bytes of a [T, 64] panel
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kKV;
  const uint32_t q_s = base + 2 * L::kKV;            // + stage · kQ
  const uint32_t do_s = q_s + kStages * L::kQ;
  const uint32_t lse_s = do_s + kStages * L::kQ;     // + stage · kStat
  const uint32_t dl_s = lse_s + kStages * L::kStat;
  uint8_t* smem_base = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t own_full = smem_u32(&bars[0]);
  const uint32_t full = own_full + 8, empty = full + 8 * kStages;

  int idx = blockIdx.x;
  const int kvh = idx % kv_heads;
  idx /= kv_heads;
  const int b = idx % batch;
  const int k0 = (idx / batch) * kRows;      // the first tiles see most rows
  const int group = heads / kv_heads;
  const int nqt = (sq + T - 1) / T;
  // the first q tile with a row at or past key k0 (q_offset + row >= k0)
  int qt0 = 0;
  if (causal && k0 - q_offset > 0) {
    const int64_t first = (k0 - q_offset) / T;
    qt0 = first < nqt ? static_cast<int>(first) : nqt;
  }
  const int per_head = nqt - qt0;
  const int n_iter = group * per_head;       // G heads × q tiles, in order

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // thread 0's TMA bytes and the stats warp's 32 lanes
      mbar_init(full + 8 * s, 1 + kWarp);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer --
    // thread 0 issues the TMA loads; warp 1 copies the stats
    regs_dec<24>();
    const bool tma = threadIdx.x == 0;
    if (n_iter > 0 && (tma || threadIdx.x / kWarp == 1)) {
      if (tma) {
        mbar_expect_tx(own_full, 2 * L::kKV);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p) {
          tma_load_4d(k_s + p * kPanelK, &tm_k, own_full, 64 * p, kvh, k0, b);
          tma_load_4d(v_s + p * kPanelK, &tm_v, own_full, 64 * p, kvh, k0,
                      b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int h = kvh * group + it / per_head;
        const int q0 = (qt0 + it % per_head) * T;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        if (tma) {
          mbar_expect_tx(bar, 2 * L::kQ);
#pragma unroll
          for (int p = 0; p < HD / 64; ++p) {
            tma_load_4d(q_s + s * L::kQ + p * kPanelQ, &tm_q, bar, 64 * p, h,
                        q0, b);
            tma_load_4d(do_s + s * L::kQ + p * kPanelQ, &tm_do, bar, 64 * p,
                        h, q0, b);
          }
        } else {
          // lse and delta of rows q0 .. q0 + T - 1 (0 past Sq: masked)
          float* lse_t = reinterpret_cast<float*>(smem_base + (lse_s - base) +
                                                  s * L::kStat);
          float* dl_t = reinterpret_cast<float*>(smem_base + (dl_s - base) +
                                                 s * L::kStat);
          const int64_t row0 = (static_cast<int64_t>(b) * heads + h) * sq;
          for (int r = threadIdx.x % kWarp; r < T; r += kWarp) {
            const bool in = q0 + r < sq;
            lse_t[r] = in ? lse[row0 + q0 + r] : 0.f;
            dl_t[r] = in ? delta[row0 + q0 + r] : 0.f;
          }
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumer --
    regs_inc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;      // and row + 8: keys
    const int col = 2 * (lane % 4);                // and col + 1, + 8·j: rows
    const int kr0 = k0 + 64 * cw + row;
    const int k_last = k0 + 64 * cw + 63;          // the warpgroup's last key
    const uint32_t k_wg = k_s + cw * 64 * 128, v_wg = v_s + cw * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[T / 2], dpt[T / 2];  // Sᵀ then Pᵀ; dPᵀ
    uint32_t pa[T / 16][4], dsa[T / 16][4];   // Pᵀ, dSᵀ: bf16 A operands

    if (n_iter > 0) mbar_wait(own_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it % per_head) * T;
      const uint32_t q_tile = q_s + s * L::kQ, do_tile = do_s + s * L::kQ;
      const float* lse_t = reinterpret_cast<const float*>(
          smem_base + (lse_s - base) + s * L::kStat);
      const float* dl_t = reinterpret_cast<const float*>(
          smem_base + (dl_s - base) + s * L::kStat);
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: HD/16 k-slices each, two commit groups
      zero(st);
      zero(dpt);
      wgmma_fence();
      fence_regs(st);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(st, desc_sw128(k_wg + (kk / 4) * kPanelK + off, 16, 1024),
                    desc_sw128(q_tile + (kk / 4) * kPanelQ + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      fence_regs(dpt);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(dpt,
                    desc_sw128(v_wg + (kk / 4) * kPanelK + off, 16, 1024),
                    desc_sw128(do_tile + (kk / 4) * kPanelQ + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();              // Sᵀ is in; dPᵀ runs on
      fence_regs(st);
      const bool edge = k0 + 64 * cw + 64 > sk || q0 + T > sq ||
                        (causal && q_offset + q0 < k_last);
#pragma unroll
      for (int i = 0; i < T / 2; i += 2) {
        const int c = 8 * (i / 4) + col;           // this pair's rows c, c+1
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        float p0 = ex2(fmaf(st[i], scale_log2, -l.x * kLog2e));
        float p1 = ex2(fmaf(st[i + 1], scale_log2, -l.y * kLog2e));
        if (edge) {
          const int kpos = kr0 + 8 * ((i / 2) % 2);
          const int qr = q0 + c;
          if (kpos >= sk || qr >= sq || (causal && q_offset + qr < kpos))
            p0 = 0.f;
          if (kpos >= sk || qr + 1 >= sq ||
              (causal && q_offset + qr + 1 < kpos))
            p1 = 0.f;
        }
        st[i] = p0;
        st[i + 1] = p1;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < T / 2; i += 2) {
        const float2 d = *reinterpret_cast<const float2*>(
            dl_t + 8 * (i / 4) + col);
        pa[i / 8][(i % 8) / 2] = pack_bf16(st[i], st[i + 1]);
        dsa[i / 8][(i % 8) / 2] = pack_bf16(st[i] * (dpt[i] - d.x),
                                            st[i + 1] * (dpt[i + 1] - d.y));
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q: T/16 k-slices of 16 rows each
      wgmma_fence();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs<HD>(dv_acc, pa[kk],
                     desc_sw128(do_tile + kk * 16 * 128, kPanelQ, 1024));
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs<HD>(dk_acc, dsa[kk],
                     desc_sw128(q_tile + kk * 16 * 128, kPanelQ, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kr0 + 8 * r;
      if (key >= sk) continue;
      const int64_t at =
          ((static_cast<int64_t>(b) * sk + key) * kv_heads + kvh) * HD + col;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * c) = pack_bf16(
            dk_acc[4 * c + 2 * r] * scale, dk_acc[4 * c + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
            pack_bf16(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
      }
    }
  }
}

float scale_of(int hd) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
}

template <int HD>
cudaError_t launch_dq(const FlashBwdArgs& a, void* dq) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, a.batch, a.sq, a.heads, HD, kRows) ||
      !make_map(&tdo, a.dout, a.batch, a.sq, a.heads, HD, kRows) ||
      !make_map(&tk, a.k, a.batch, a.sk, a.kv_heads, HD, tile_of(HD)) ||
      !make_map(&tv, a.v, a.batch, a.sk, a.kv_heads, HD, tile_of(HD)))
    return cudaErrorInvalidValue;
  constexpr int smem = DqLayout<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      static_cast<int64_t>((a.sq + kRows - 1) / kRows) * a.batch * a.heads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq),
      a.batch, a.heads, a.heads / a.kv_heads, a.sq, a.sk, a.causal,
      a.q_offset, scale_of(HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const FlashBwdArgs& a, void* dk, void* dv) {
  constexpr int T = tile_of(HD);
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, a.batch, a.sq, a.heads, HD, T) ||
      !make_map(&tdo, a.dout, a.batch, a.sq, a.heads, HD, T) ||
      !make_map(&tk, a.k, a.batch, a.sk, a.kv_heads, HD, kRows) ||
      !make_map(&tv, a.v, a.batch, a.sk, a.kv_heads, HD, kRows))
    return cudaErrorInvalidValue;
  constexpr int smem = DkvLayout<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      static_cast<int64_t>((a.sk + kRows - 1) / kRows) * a.batch * a.kv_heads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_dkv_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.batch, a.heads, a.kv_heads, a.sq,
      a.sk, a.causal, a.q_offset, scale_of(HD));
  return cudaGetLastError();
}

}  // namespace

int flash_bwd_wgmma_smem(int hd, int dkv) {
  const int bars = 8 * kBars;
  if (hd == 64)
    return (dkv ? DkvLayout<64>::kAlloc : DqLayout<64>::kAlloc) + bars;
  if (hd == 128)
    return (dkv ? DkvLayout<128>::kAlloc : DqLayout<128>::kAlloc) + bars;
  return -1;
}

cudaError_t flash_bwd_dq_wgmma(const FlashBwdArgs& a, void* dq) {
  if (a.hd == 64) return launch_dq<64>(a, dq);
  if (a.hd == 128) return launch_dq<128>(a, dq);
  return cudaErrorInvalidValue;
}

cudaError_t flash_bwd_dkv_wgmma(const FlashBwdArgs& a, void* dk, void* dv) {
  if (a.hd == 64) return launch_dkv<64>(a, dk, dv);
  if (a.hd == 128) return launch_dkv<128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
