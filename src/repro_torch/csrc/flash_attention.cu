// Flash attention forward (kernel 6): the C entry point, and the float32
// kernel.
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::_flash_fwd
//   (body _flash_fwd_kernel): for q [B, Sq, H, HD] and k, v [B, Sk, KV,
//   HD], H = KV·G (query head h reads kv head h / G in place, the
//   reference's [KV, G] grouping), float32 or bfloat16, HD 64 or 128:
//   out [B, Sq, H, HD] in q's type and lse [B, H, Sq] float32 of the
//   softmax(q·kᵀ / √HD + mask) · v, the mask causal from q_offset (the
//   absolute position of q[0]) and always past Sk. The LM's prefill and
//   training call it once per layer, through
//   models/attention.py::chunked_attention.
//
// bfloat16 calls (every full-width path) go to the tensor-core kernel in
// flash_fwd_wgmma.cu. float32 calls (the 2-layer card-vs-CPU checks and
// the parity sweep) run the kernel below.
//
// Bound on an H100: every unmasked (q, k) pair costs 4·HD flops (q·k and
// p·v); in float32 the products run at the 67 TFLOP/s of the CUDA cores.
//
// Design of the float32 kernel: one block of 256 threads per (b·h, 64-row
// q tile), a loop over 64-key tiles up to the diagonal (the TPU's
// sequential kv grid axis and its VMEM carry become this loop and
// registers); q tiles are issued heaviest first so that the short causal
// tiles fill the tail. Q, then K, then V tiles are staged in shared memory
// as float32, rows padded by 4 floats so the float4 reads spread over the
// banks; K and V share one buffer (85 KB at HD 128, two blocks an SM).
// Each thread owns a 4×4 patch of the 64×64 score tile (rows 4·tr.., keys
// tc + 16·j) and the same 4 rows × HD/16 columns of the output
// accumulator; row max and row sum are butterfly shuffles over the 16
// lanes of a row group. The softmax is the TPU kernel's: scores scaled by
// 1/√HD, masked lanes + NEG_INF, the running max clamped at NEG_INF/2 so
// fully masked rows give 0 and not NaN, l summed from P, out = acc /
// max(l, 1e-30), lse = m + log(max(l, 1e-30)). Rows past Sq and keys past
// Sk are masked here (the TPU pads them); K and V rows past Sk are
// zero-filled so that a masked p = 0 never meets a stale value. All
// products are float32 FMAs on the CUDA cores, in order of the reduced
// index.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

__host__ __device__ constexpr int smem_floats(int hd) {
  return 2 * kBQ * ld_of(hd) + kBQ * kPadP;   // Q, K/V, P
}

// max / sum over the 16 lanes of a row group (lanes 0-15 or 16-31); the
// butterfly leaves the same bits in every lane of the group
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int heads, int kv_heads,
                     int sq, int sk, int causal, int64_t q_offset,
                     float scale) {
  constexpr int LD = ld_of(HD);
  constexpr int kCols = HD / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* kv_s = q_s + kBQ * LD;                    // [kBK][LD], K then V
  float* p_s = kv_s + kBK * LD;                    // [kBQ][kPadP]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int64_t row_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t kvh = h / (heads / kv_heads);
  const float* q_b = q + (static_cast<int64_t>(b) * sq + q0) * row_stride +
                 static_cast<int64_t>(h) * HD;
  const float* k_b = k + static_cast<int64_t>(b) * sk * kv_stride + kvh * HD;
  const float* v_b = v + static_cast<int64_t>(b) * sk * kv_stride + kvh * HD;

  load_tile<HD>(q_s, q_b, row_stride, sq - q0);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
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
    load_tile<HD>(kv_s, k_b + static_cast<int64_t>(k0) * kv_stride,
                     kv_stride, sk - k0);
    __syncthreads();

    float s[4][4];
    tile_dot<HD>(s, q_s, kv_s, tr, tc);
    __syncthreads();                    // every read of K is done

    // online softmax over this tile; P goes to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
      const int64_t qpos = q_offset + q0 + r;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = s[i][j] * scale + (ok ? 0.f : kNegInf);
        mb = fmaxf(mb, s[i][j]);
      }
      mb = group_max(mb);
      const float m_new = fmaxf(fmaxf(m[i], mb), kNegInf / 2);
      const float c = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_s[r * kPadP + tc + 16 * j] = p;
      }
      l[i] = l[i] * c + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int col = 0; col < kCols; ++col) acc[i][col] *= c;
    }
    load_tile<HD>(kv_s, v_b + static_cast<int64_t>(k0) * kv_stride,
                     kv_stride, sk - k0);
    __syncthreads();

    // acc += P · V over the tile's keys
    tile_acc<HD>(acc, p_s, kv_s, tr, tc);
    __syncthreads();                    // every read of V and P is done
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (q0 + r >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<int64_t>(b) * sq + q0 + r) * row_stride +
           static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int f = 0; f < kCols / 4; ++f)
      store4(o + 64 * f + 4 * tc, acc[i][4 * f] / lc, acc[i][4 * f + 1] / lc,
             acc[i][4 * f + 2] / lc, acc[i][4 * f + 3] / lc);
    if (tc == 0) lse[static_cast<int64_t>(bh) * sq + q0 + r] = m[i] + logf(lc);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int heads, int kv_heads, int sq,
                   int sk, int causal, int64_t q_offset, cudaStream_t stream) {
  constexpr int smem = smem_floats(HD) * 4;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, heads,
      kv_heads, sq, sk, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// flash_fwd_wgmma.cu: the bfloat16 kernel
int flash_fwd_wgmma_smem(int hd);
cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int heads,
                            int kv_heads, int sq, int sk, int hd, int causal,
                            int64_t q_offset, cudaStream_t stream);

// The shared memory one block takes at head dim `hd` (bf16 != 0: the
// bfloat16 kernel, else the float32 one), in bytes (the wrapper holds it
// against the device's opt-in limit).
extern "C" int reach_flash_smem(int hd, int bf16) {
  return bf16 ? flash_fwd_wgmma_smem(hd) : smem_floats(hd) * 4;
}

// q, out [B, Sq, H, hd] and k, v [B, Sk, KV, hd] contiguous, 16-byte
// aligned, of one type (bf16 != 0: bfloat16, else float32), KV dividing
// H; lse [B, H, Sq] float32. hd is 64 or 128; B·H < 2^31, ceil(Sq / 64)
// <= 65535.
extern "C" int reach_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int batch, int heads,
                               int kv_heads, int sq, int sk, int hd,
                               int bf16, int causal, int64_t q_offset,
                               cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (sk < 1 || q_offset < 0 || kv_heads < 1 || heads % kv_heads ||
      (sq + kBQ - 1) / kBQ > 65535 ||
      static_cast<int64_t>(batch) * heads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (bf16)
    err = flash_fwd_wgmma(q, k, v, out, lse, batch, heads, kv_heads, sq, sk,
                          hd, causal, q_offset, stream);
  else if (hd == 64)
    err = launch<64>(q, k, v, out, lse, batch, heads, kv_heads, sq, sk,
                     causal, q_offset, stream);
  else if (hd == 128)
    err = launch<128>(q, k, v, out, lse, batch, heads, kv_heads, sq, sk,
                      causal, q_offset, stream);
  return static_cast<int>(err);
}
