// Flash attention forward (kernel 6).
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::_flash_fwd
//   (body _flash_fwd_kernel): for q [B, Sq, H, HD] and k, v [B, Sk, H, HD]
//   (GQA heads already expanded), float32 or bfloat16, HD 64 or 128:
//   out [B, Sq, H, HD] in q's type and lse [B, H, Sq] float32 of the
//   softmax(q·kᵀ / √HD + mask) · v, the mask causal from q_offset (the
//   absolute position of q[0]) and always past Sk. The LM's prefill calls
//   it once per layer, through models/attention.py::chunked_attention.
//
// Bound on an H100: every unmasked (q, k) pair costs 4·HD flops (q·k and
// p·v), so a causal call from offset 0 does 2·HD·S·(S+1) flops per head
// on 4·B·H·S·HD elements plus lse: at llama3-8b's prefill layer (S 32,768,
// H 32, HD 128, bf16) 8.80 TFLOP on 1.08 GB, 8.9 ms at the bf16 tensor-
// core peak (989 TFLOP/s) against 0.32 ms of memory: bound by operations.
//
// Design: one block of 256 threads per (b·h, 64-row q tile), a loop over
// 64-key tiles up to the diagonal (the TPU's sequential kv grid axis and
// its VMEM carry become this loop and registers); q tiles are issued
// heaviest first so that the short causal tiles fill the tail. Q, then K,
// then V tiles are staged in shared memory as float32 (bfloat16 is widened
// once per load), rows padded by 4 floats so the float4 reads spread over
// the banks; K and V share one buffer, so a block takes 85 KB at HD 128
// and two blocks fit on an SM. Each thread owns a 4×4 patch of the 64×64
// score tile (rows 4·tr.., keys tc + 16·j) and the same 4 rows × HD/16
// columns of the output accumulator; row max and row sum are butterfly
// shuffles over the 16 lanes of a row group. The softmax is the TPU
// kernel's: scores scaled by 1/√HD, masked lanes + NEG_INF, the running max
// clamped at NEG_INF/2 so fully masked rows give 0 and not NaN, P rounded
// to v's type before P·V, l summed from the unrounded P, out = acc / max(l,
// 1e-30), lse = m + log(max(l, 1e-30)). Rows past Sq and keys past Sk are
// masked here (the TPU pads them); K and V rows past Sk are zero-filled so
// that a masked p = 0 never meets a stale value. All products are float32
// FMAs on the CUDA cores (no tensor cores), so the kernel is bound by the
// 67 TFLOP/s float32 rate, far above the bf16 bound: mma/wgmma tiles and
// TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kPadP = kBK + 4;          // row stride of the P tile (floats)
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages kBQ rows for Q, K and V");

__host__ __device__ constexpr int ld_of(int hd) { return hd + 4; }

__host__ __device__ constexpr int smem_floats(int hd) {
  return 2 * kBQ * ld_of(hd) + kBQ * kPadP;   // Q, K/V, P
}

__device__ __forceinline__ float4 to_f32x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One tile of `rows` rows (row stride `stride` elements) into shared memory
// as float32 [kBQ][LD]; rows at or past `valid` are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);            // elements per 16 B load
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float* out = dst + r * ld_of(HD) + c;
    if (r >= valid) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(out + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(&raw);
    } else {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c2 = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(out) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(out + 4) = make_float4(c2.x, c2.y, d.x, d.y);
    }
  }
}

// P as the P·V product sees it: rounded to v's type
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(p));
  return p;
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int heads, int sq, int sk,
                     int causal, int64_t q_offset, float scale) {
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
  const T* q_b = q + (static_cast<int64_t>(b) * sq + q0) * row_stride +
                 static_cast<int64_t>(h) * HD;
  const T* k_b = k + static_cast<int64_t>(b) * sk * row_stride +
                 static_cast<int64_t>(h) * HD;
  const T* v_b = v + static_cast<int64_t>(b) * sk * row_stride +
                 static_cast<int64_t>(h) * HD;

  load_tile<T, HD>(q_s, q_b, row_stride, sq - q0);

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
    load_tile<T, HD>(kv_s, k_b + static_cast<int64_t>(k0) * row_stride,
                     row_stride, sk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = to_f32x4(q_s + (4 * tr + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = to_f32x4(kv_s + (tc + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          s[i][j] = fmaf(qa[i].w, ka[j].w, a);
        }
    }
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
        p_s[r * kPadP + tc + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * c + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int col = 0; col < kCols; ++col) acc[i][col] *= c;
    }
    load_tile<T, HD>(kv_s, v_b + static_cast<int64_t>(k0) * row_stride,
                     row_stride, sk - k0);
    __syncthreads();

    // acc += P · V over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = to_f32x4(p_s + (4 * tr + i) * kPadP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int f = 0; f < kCols / 4; ++f) {
          const float4 vb = to_f32x4(kv_s + (kk + t) * LD + 64 * f + 4 * tc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pa[i].x : t == 1 ? pa[i].y
                          : t == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * f + 0] = fmaf(p, vb.x, acc[i][4 * f + 0]);
            acc[i][4 * f + 1] = fmaf(p, vb.y, acc[i][4 * f + 1]);
            acc[i][4 * f + 2] = fmaf(p, vb.z, acc[i][4 * f + 2]);
            acc[i][4 * f + 3] = fmaf(p, vb.w, acc[i][4 * f + 3]);
          }
        }
      }
    }
    __syncthreads();                    // every read of V and P is done
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (q0 + r >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<int64_t>(b) * sq + q0 + r) * row_stride +
           static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int f = 0; f < kCols / 4; ++f)
      store4(o + 64 * f + 4 * tc, acc[i][4 * f] / lc, acc[i][4 * f + 1] / lc,
             acc[i][4 * f + 2] / lc, acc[i][4 * f + 3] / lc);
    if (tc == 0) lse[static_cast<int64_t>(bh) * sq + q0 + r] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int heads, int sq, int sk,
                   int causal, int64_t q_offset, cudaStream_t stream) {
  constexpr int smem = smem_floats(HD) * 4;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, heads, sq, sk,
      causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// The shared memory one block needs at head dim `hd`, in bytes (the
// wrapper holds it against the device's opt-in limit).
extern "C" int reach_flash_smem(int hd) { return smem_floats(hd) * 4; }

// q, out [B, Sq, H, hd] and k, v [B, Sk, H, hd] contiguous, 16-byte
// aligned, of one type (bf16 != 0: bfloat16, else float32); lse [B, H, Sq]
// float32. hd is 64 or 128; B·H < 2^31, ceil(Sq / 64) <= 65535.
extern "C" int reach_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int batch, int heads,
                               int sq, int sk, int hd, int bf16, int causal,
                               int64_t q_offset, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (sk < 1 || q_offset < 0 || (sq + kBQ - 1) / kBQ > 65535 ||
      static_cast<int64_t>(batch) * heads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 64 && bf16)
    err = launch<__nv_bfloat16, 64>(q, k, v, out, lse, batch, heads, sq, sk,
                                    causal, q_offset, stream);
  else if (hd == 128 && bf16)
    err = launch<__nv_bfloat16, 128>(q, k, v, out, lse, batch, heads, sq,
                                     sk, causal, q_offset, stream);
  else if (hd == 64)
    err = launch<float, 64>(q, k, v, out, lse, batch, heads, sq, sk, causal,
                            q_offset, stream);
  else if (hd == 128)
    err = launch<float, 128>(q, k, v, out, lse, batch, heads, sq, sk, causal,
                             q_offset, stream);
  return static_cast<int>(err);
}
