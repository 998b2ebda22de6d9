// Flash attention forward on the tensor cores (kernel 6, bfloat16).
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::_flash_fwd
//   (body _flash_fwd_kernel) for bfloat16 q [B, Sq, H, HD] and k, v
//   [B, Sk, KV, HD], H = KV·G, HD 64 or 128: out [B, Sq, H, HD] bfloat16
//   and lse [B, H, Sq] float32 of softmax(q·kᵀ / √HD + mask) · v, the mask
//   causal from q_offset (the absolute position of q[0]) and always past
//   Sk. Query head h reads kv head h / G in place (the reference's [KV, G]
//   grouping; its TPU kernel takes the heads expanded). float32 calls stay
//   on the FMA kernel in flash_attention.cu.
//
// Bound on an H100: 4·HD flops for every unmasked (q, k) pair against
// 2·(2·B·Sq·H + 2·B·Sk·KV)·HD bytes: at llama3-8b's prefill layer (S
// 32,768, H 32, KV 8, HD 128) 8.80 TFLOP, 8.9 ms at the bf16 tensor-core
// peak (989 TFLOP/s) against 0.2 ms of memory: bound by operations.
//
// Design (after FlashAttention-3): one block of three warpgroups per
// (128-row q tile, b, h). Warpgroup 0 is the producer: one thread loads
// the Q tile once and then K and V tiles of 128 keys with TMA into a ring
// of two stages each, 128-byte swizzled, each stage guarded by a "full"
// mbarrier (TMA bytes arrived) and an "empty" one (both consumers done
// with it), so the next tiles load while this one is computed. It gives
// its registers away (setmaxnreg 24). Warpgroups 1 and 2 are consumers
// (setmaxnreg 240) and own 64 query rows each. A consumer works on key
// tiles as a two-deep software pipeline: with tile j - 1's P in hand it
//   - issues S = Q·Kᵀ of tile j (HD/16 wgmma m64n128k16 from shared
//     memory, both K-major, into 64 float32 registers) and then O += P·V
//     of tile j - 1 (128/16 wgmma m64nHDk16: P the A operand from
//     registers, V from shared memory MN-major via the transpose bit),
//     both asynchronous;
//   - waits for S alone, frees K, and runs tile j's online softmax while
//     the tensor cores work on P·V: the mask only where the tile crosses
//     the causal diagonal of its rows or Sk (every other tile skips it),
//     row max and row sum over the four threads that share a row (two
//     shuffles), exp2 with 1/√HD·log2(e) folded into one FMA;
//   - waits for P·V, frees V, rescales O by exp2(m_old - m_new) and
//     rounds tile j's P to bf16 in its registers: the next A operand (no
//     shared memory).
// The two consumers run the same tiles out of step, so one's softmax
// overlaps the other's MMAs. Semantics are the TPU kernel's: the running
// max clamped at NEG_INF/2, masked lanes 0, P rounded to v's dtype for
// P·V with l summed from the unrounded P, out = acc / max(l, 1e-30) in
// bf16, lse = m + log(max(l, 1e-30)) in natural log. Rows past Sq arrive
// from TMA as zeros and are not stored; keys past Sk are masked and their
// K, V rows arrive as zeros, so p = 0 never meets a stale value. The
// block's q tiles are issued heaviest first, and the G query heads of one
// kv head next to each other, so that their K/V tiles meet in L2.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kPanelQ = kBQ * 128;   // bytes of one [rows, 64] panel
constexpr int kPanelK = kBK * 128;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int kQ = kBQ * HD * 2;     // the Q tile, bytes
  static constexpr int kKV = kBK * HD * 2;    // one K or V tile
  static constexpr int kBytes = kQ + 2 * kStages * kKV;
  static constexpr int kAlloc = kBytes + 1024;   // room to align to 1024 B
};
constexpr int kBars = 1 + 4 * kStages;   // Q; K, V full and empty a stage

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int batch, int heads,
                           int group, int sq, int sk, int causal,
                           int64_t q_offset, float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQ;                 // + stage · kKV
  const uint32_t v_s = k_s + kStages * L::kKV;
  const uint32_t q_full = smem_u32(&bars[0]);
  // full and empty barriers of K and V per stage: 8 bytes apart
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  int idx = blockIdx.x;
  const int h = idx % heads;
  idx /= heads;
  const int b = idx % batch;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - idx / batch) * kBQ;       // heaviest first
  // keys the block's last valid row may see
  int64_t k_end = sk;
  if (causal) {
    const int64_t last = q_offset + min(q0 + kBQ, sq);
    if (last < k_end) k_end = last;
  }
  const int n_tiles = static_cast<int>((k_end + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);
      mbar_init(v_empty + 8 * s, 2 * 128);
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
      mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int p = 0; p < HD / 64; ++p)
        tma_load_4d(q_s + p * kPanelQ, &tm_q, q_full, 64 * p, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, L::kKV);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p)
          tma_load_4d(k_s + s * L::kKV + p * kPanelK, &tm_k, k_full + 8 * s,
                      64 * p, kvh, j * kBK, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, L::kKV);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p)
          tma_load_4d(v_s + s * L::kKV + p * kPanelK, &tm_v, v_full + 8 * s,
                      64 * p, kvh, j * kBK, b);
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
    // absolute position of the warpgroup's first row
    const int64_t qa0 = q_offset + q0 + 64 * cw;
    const uint32_t q_wg = q_s + cw * 64 * 128;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float sc[kBK / 2];            // S of the tile in hand, then its P
    uint32_t pa[kBK / 16][4];     // P of the tile before, bf16 A operand

    // S = Q·Kᵀ of tile j: HD/16 k-slices of 16 (32 bytes of a 128-byte
    // row), issued and committed, not waited for
    auto issue_s = [&](int j) {
      const uint32_t k_tile = k_s + (j % kStages) * L::kKV;
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(sc,
                      desc_sw128(q_wg + (kk / 4) * kPanelQ + off, 16, 1024),
                      desc_sw128(k_tile + (kk / 4) * kPanelK + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
    };
    // O += P·V of tile j: 128/16 k-slices of 16 keys (2 KB of V rows)
    auto issue_pv = [&](int j) {
      const uint32_t v_tile = v_s + (j % kStages) * L::kKV;
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs<HD>(o, pa[kk],
                     desc_sw128(v_tile + kk * 16 * 128, kPanelK, 1024));
      }
      wgmma_commit();
    };
    // the online softmax of tile j on the fragment (rows row and row + 8):
    // sc becomes P (float), m and l move on, corr rescales the output
    auto softmax = [&](int j) {
      const int k0 = j * kBK;
      if (k0 + kBK > sk || (causal && k0 + kBK - 1 > qa0)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col + (i % 2);
          const int64_t qpos = qa0 + row + 8 * ((i / 2) % 2);
          if (kpos >= sk || (causal && qpos < kpos)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, mneg[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(fmaxf(m[r], mx[r] * scale_log2),
                                  kNegInf / 2);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        mneg[r] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, mneg[(i / 2) % 2]));
        ps[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
    };
    // rescale the output, then P to bf16 (the next P·V's A operand)
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2)
        pa[i / 8][(i % 8) / 2] = pack_bf16(sc[i], sc[i + 1]);
    };

    // A software pipeline: S of tile j runs on the tensor cores beside
    // P·V of tile j - 1, and the softmax of tile j beside that P·V.
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty);
    softmax(0);
    rescale_and_pack();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(k_full + 8 * s, (j / kStages) & 1);
      mbar_wait(v_full + 8 * sp, ((j - 1) / kStages) & 1);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();              // S of tile j is in
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      softmax(j);
      wgmma_wait<0>();              // P·V of tile j - 1 is in
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(v_empty + 8 * sp);
      rescale_and_pack();
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full + 8 * (last % kStages), (last / kStages) & 1);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(v_empty + 8 * (last % kStages));

    // out = acc / max(l, 1e-30); lse = m·ln 2 + log(max(l, 1e-30))
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qr = q0 + 64 * cw + row + 8 * r;
      if (qr >= sq) continue;
      const float lc = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst =
          out + ((static_cast<int64_t>(b) * sq + qr) * heads + h) * HD + col;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) =
            pack_bf16(o[4 * c + 2 * r] / lc, o[4 * c + 2 * r + 1] / lc);
      if (lane % 4 == 0)
        lse[(static_cast<int64_t>(b) * heads + h) * sq + qr] =
            m[r] * 0.6931471805599453f + logf(lc);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int heads, int kv_heads, int sq,
                   int sk, int causal, int64_t q_offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, sq, heads, HD, kBQ) ||
      !make_map(&tk, k, batch, sk, kv_heads, HD, kBK) ||
      !make_map(&tv, v, batch, sk, kv_heads, HD, kBK))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(double(HD)));
  const int64_t blocks =
      static_cast<int64_t>((sq + kBQ - 1) / kBQ) * batch * heads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, batch, heads,
      heads / kv_heads, sq, sk, causal, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The shared memory one block of the bf16 kernel takes at head dim `hd`
// (its tiles, 1 KB of alignment and the barriers), in bytes; -1 for
// another hd.
int flash_fwd_wgmma_smem(int hd) {
  const int bars = 8 * kBars;
  return hd == 64 ? Layout<64>::kAlloc + bars
         : hd == 128 ? Layout<128>::kAlloc + bars : -1;
}

// q, out [B, Sq, H, hd] and k, v [B, Sk, KV, hd] bf16, contiguous and
// 16-byte aligned, KV dividing H; lse [B, H, Sq] float32.
cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int heads,
                            int kv_heads, int sq, int sk, int hd, int causal,
                            int64_t q_offset, cudaStream_t stream) {
  if (hd == 64)
    return launch<64>(q, k, v, out, lse, batch, heads, kv_heads, sq, sk,
                      causal, q_offset, stream);
  if (hd == 128)
    return launch<128>(q, k, v, out, lse, batch, heads, kv_heads, sq, sk,
                       causal, q_offset, stream);
  return cudaErrorInvalidValue;
}
