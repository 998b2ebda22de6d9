// Flash attention backward: dq (kernel 7) and dk, dv (kernel 8): the C
// entry points, and the float32 kernels.
//
// Replace the two Pallas calls of
//   src/repro/kernels/flash_attention.py::_flash_vjp_bwd
//   (bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel): for q, do
//   [B, Sq, H, HD] and k, v [B, Sk, KV, HD], H = KV·G (query head h reads
//   kv head h / G in place, the reference's [KV, G] grouping) of one type,
//   float32 or bfloat16, HD 64 or 128, the forward's lse and the row sums
//   delta = Σ_hd do·out (both [B, H, Sq] float32), the recomputation form
//   of the gradient:
//     P   = exp(q·kᵀ·scale − lse), masked lanes set to 0 by a select
//     dP  = do·vᵀ,  dS = P ∘ (dP − delta)
//     dq  = scale · dS·k,  dk = scale · Σ_g dSᵀ·q,  dv = Σ_g Pᵀ·do
//   with the TPU kernels' roundings: P to do's type before Pᵀ·do, dS to k's
//   and q's type before dS·k and dSᵀ·q, float32 sums, and the outputs cast
//   to q's, k's and v's type; dk and dv [B, Sk, KV, HD] sum the G query
//   heads of each kv head in float32 and are rounded once. The masks are
//   keys ≥ Sk, query rows ≥ Sq and, when causal, q_offset + row < key. The
//   LM's training backward calls each once per layer and microbatch.
//
// bfloat16 calls (every full-width path) go to the tensor-core kernels in
// flash_bwd_wgmma.cu. float32 calls (the 2-layer card-vs-CPU checks and
// the parity sweep) run the kernels below.
//
// Bound on an H100: every unmasked (q, k) pair costs 6·HD flops in kernel 7
// (q·k, do·v, dS·k) and 8·HD in kernel 8 (q·k, do·v, Pᵀ·do, dSᵀ·q); in
// float32 the products run at the 67 TFLOP/s of the CUDA cores.
//
// Design of the float32 kernels: the TPU's sequential grid axis and its
// VMEM accumulators become a loop inside one 256-thread block and
// registers; the two kernels have no atomics, so the gradients are the
// same bits from run to run.
//   Kernel 7: one block per (b·h, 64-row q tile), heaviest first; Q and do
//   tiles stay in shared memory while K and V tiles of kv head h / G
//   stream by, up to the diagonal. Each thread owns a 4×4 patch of the
//   64×64 S and dP tiles (rows 4·tr.., keys tc + 16·j), writes its dS to a
//   shared tile, and accumulates 4 rows × HD/16 columns of dq.
//   Kernel 8: one block per (b·kv, 64-key tile); K and V tiles stay while
//   Q and do tiles of each of the G query heads in turn stream by from the
//   diagonal's first tile to Sq. A thread owns a 4×4 patch of the
//   transposed tiles Sᵀ and dPᵀ (keys 4·tr.., rows tc + 16·j), writes Pᵀ
//   and dSᵀ to shared tiles, and accumulates 4 key rows × HD/16 columns of
//   dk and of dv over all G heads.
// Operands are staged as float32 and every product is a float32 FMA on the
// CUDA cores. A block takes 85 / 103 KB of shared memory (kernels 7 / 8)
// at HD 64, two blocks to an SM, and 149 / 167 KB at HD 128, one.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_bwd_args.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace flash;

__host__ __device__ constexpr int dq_smem_floats(int hd) {
  return 4 * kBQ * ld_of(hd) + kBQ * kPadP;          // Q, do, K, V, dS
}
__host__ __device__ constexpr int dkv_smem_floats(int hd) {
  return 4 * kBQ * ld_of(hd) + 2 * kBK * kPadP + 2 * kBQ;  // + Pᵀ, dSᵀ, stats
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq,
                        int heads, int kv_heads, int sq, int sk, int causal,
                        int64_t q_offset, float scale) {
  constexpr int LD = ld_of(HD);
  constexpr int kCols = HD / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;                    // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;                    // [kBK][LD]
  float* v_s = k_s + kBK * LD;                     // [kBK][LD]
  float* ds_s = v_s + kBK * LD;                    // [kBQ][kPadP]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int64_t row_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * row_stride +
                        static_cast<int64_t>(h) * HD;
  const int64_t k_off = static_cast<int64_t>(b) * sk * kv_stride +
                        static_cast<int64_t>(h / (heads / kv_heads)) * HD;

  load_tile<HD>(q_s, q + q_off, row_stride, sq - q0);
  load_tile<HD>(do_s, dout + q_off, row_stride, sq - q0);

  float lse_r[4], d_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    const int64_t at = static_cast<int64_t>(bh) * sq + row;
    lse_r[i] = row < sq ? lse[at] : 0.f;
    d_r[i] = row < sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  // keys this tile's rows may see: up to the diagonal of its last row
  int64_t k_end = sk;
  if (causal) {
    const int64_t last = q_offset + q0 + kBQ;
    if (last < k_end) k_end = last;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int64_t at = k_off + static_cast<int64_t>(k0) * kv_stride;
    load_tile<HD>(k_s, k + at, kv_stride, sk - k0);
    load_tile<HD>(v_s, v + at, kv_stride, sk - k0);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(s, q_s, k_s, tr, tc);
    tile_dot<HD>(dp, do_s, v_s, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
      const int64_t qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool ok = kpos < sk && q0 + r < sq && (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[r * kPadP + tc + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();

    tile_acc<HD>(acc, ds_s, k_s, tr, tc);      // acc += dS · K
    __syncthreads();                           // every read of K, V, dS done
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (q0 + r >= sq) continue;
    store_row<HD>(dq + q_off + r * row_stride, acc[i], scale, tc);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int kv_heads, int sq, int sk, int causal,
                         int64_t q_offset, float scale) {
  constexpr int LD = ld_of(HD);
  constexpr int kCols = HD / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBK][LD]
  float* v_s = k_s + kBK * LD;                     // [kBK][LD]
  float* q_s = v_s + kBK * LD;                     // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;                    // [kBQ][LD]
  float* pt_s = do_s + kBQ * LD;                   // [kBK][kPadP], Pᵀ
  float* dst_s = pt_s + kBK * kPadP;               // [kBK][kPadP], dSᵀ
  float* lse_s = dst_s + kBK * kPadP;              // [kBQ]
  float* d_s = lse_s + kBQ;                        // [kBQ]

  const int bkv = blockIdx.x;
  const int b = bkv / kv_heads, kvh = bkv % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * kBK;            // the first tiles see most rows
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int64_t row_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t k_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride +
                        static_cast<int64_t>(kvh) * HD;

  load_tile<HD>(k_s, k + k_off, kv_stride, sk - k0);
  load_tile<HD>(v_s, v + k_off, kv_stride, sk - k0);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // the first q tile with a row at or past key k0 (q_offset + row >= k0)
  int q_start = 0;
  if (causal && k0 - q_offset > 0)
    q_start = static_cast<int>((k0 - q_offset) / kBQ) * kBQ;
  // the G query heads of kv head kvh in order, each over its q tiles
  for (int h = kvh * group; h < (kvh + 1) * group; ++h)
  for (int q0 = q_start; q0 < sq; q0 += kBQ) {
    const int bh = b * heads + h;
    const int64_t at = (static_cast<int64_t>(b) * sq + q0) * row_stride +
                       static_cast<int64_t>(h) * HD;
    load_tile<HD>(q_s, q + at, row_stride, sq - q0);
    load_tile<HD>(do_s, dout + at, row_stride, sq - q0);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      const int64_t stat = static_cast<int64_t>(bh) * sq + row;
      lse_s[threadIdx.x] = row < sq ? lse[stat] : 0.f;
      d_s[threadIdx.x] = row < sq ? delta[stat] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];                 // [key][row] patches
    tile_dot<HD>(st, k_s, q_s, tr, tc);
    tile_dot<HD>(dpt, v_s, do_s, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const bool ok = kpos < sk && q0 + c < sq &&
                        (!causal || q_offset + q0 + c >= kpos);
        const float p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        pt_s[(4 * tr + i) * kPadP + c] = p;
        dst_s[(4 * tr + i) * kPadP + c] = p * (dpt[i][j] - d_s[c]);
      }
    }
    __syncthreads();

    tile_acc<HD>(dv_acc, pt_s, do_s, tr, tc);    // dv += Pᵀ · do
    tile_acc<HD>(dk_acc, dst_s, q_s, tr, tc);    // dk += dSᵀ · Q
    __syncthreads();                    // every read of Q, do, Pᵀ, dSᵀ done
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (k0 + r >= sk) continue;
    store_row<HD>(dk + k_off + r * kv_stride, dk_acc[i], scale, tc);
    store_row<HD>(dv + k_off + r * kv_stride, dv_acc[i], 1.f, tc);
  }
}

template <int HD>
cudaError_t launch_dq(const FlashBwdArgs& a, void* dq) {
  constexpr int smem = dq_smem_floats(HD) * 4;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.batch * a.heads),
                  static_cast<unsigned>((a.sq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.heads, a.kv_heads, a.sq,
      a.sk, a.causal, a.q_offset, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const FlashBwdArgs& a, void* dk, void* dv) {
  constexpr int smem = dkv_smem_floats(HD) * 4;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.batch * a.kv_heads),
                  static_cast<unsigned>((a.sk + kBK - 1) / kBK));
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv),
      a.heads, a.kv_heads, a.sq, a.sk, a.causal, a.q_offset, scale);
  return cudaGetLastError();
}

// 0 when the sizes are in the kernels' range, else the error to return
cudaError_t refuse(const FlashBwdArgs& a) {
  if (a.sk < 1 || a.q_offset < 0 || a.kv_heads < 1 ||
      a.heads % a.kv_heads || (a.sq + kBQ - 1) / kBQ > 65535 ||
      (a.sk + kBK - 1) / kBK > 65535 ||
      static_cast<int64_t>(a.batch) * a.heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// The shared memory one block needs at head dim `hd`, in bytes: kernel 7
// (dkv == 0) or kernel 8 (dkv != 0), the bfloat16 kernels (bf16 != 0) or
// the float32 ones.
extern "C" int reach_flash_bwd_smem(int hd, int dkv, int bf16) {
  if (bf16) return flash_bwd_wgmma_smem(hd, dkv);
  return (dkv ? dkv_smem_floats(hd) : dq_smem_floats(hd)) * 4;
}

// q, dout, dq [B, Sq, H, hd] and k, v [B, Sk, KV, hd] contiguous, 16-byte
// aligned, of one type (bf16 != 0: bfloat16, else float32), KV dividing H;
// lse and delta [B, H, Sq] float32, 16-byte aligned. hd is 64 or 128;
// B·H < 2^31, ceil(Sq / 64) <= 65535.
extern "C" int reach_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int batch,
                                  int heads, int kv_heads, int sq, int sk,
                                  int hd, int bf16, int causal,
                                  int64_t q_offset, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  const FlashBwdArgs a{q, k, v, dout, lse, delta, batch, heads, kv_heads,
                       sq, sk, hd, causal, q_offset, stream};
  cudaError_t err = refuse(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaErrorInvalidValue;
  if (bf16)
    err = flash_bwd_dq_wgmma(a, dq);
  else if (hd == 64) err = launch_dq<64>(a, dq);
  else if (hd == 128) err = launch_dq<128>(a, dq);
  return static_cast<int>(err);
}

// As reach_flash_bwd_dq, with dk and dv [B, Sk, KV, hd] of the same type
// for outputs; ceil(Sk / 64) <= 65535.
extern "C" int reach_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int batch, int heads,
                                   int kv_heads, int sq, int sk, int hd,
                                   int bf16, int causal, int64_t q_offset,
                                   cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sk <= 0) return 0;
  const FlashBwdArgs a{q, k, v, dout, lse, delta, batch, heads, kv_heads,
                       sq, sk, hd, causal, q_offset, stream};
  cudaError_t err = refuse(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaErrorInvalidValue;
  if (bf16)
    err = flash_bwd_dkv_wgmma(a, dk, dv);
  else if (hd == 64) err = launch_dkv<64>(a, dk, dv);
  else if (hd == 128) err = launch_dkv<128>(a, dk, dv);
  return static_cast<int>(err);
}
