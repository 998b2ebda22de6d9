// Tiles shared by the float32 flash attention kernels (6, 7 and 8; their
// bfloat16 calls run the tensor-core kernels): 64-row tiles of q, k, v or
// do staged in shared memory, and the two tile products of a 256-thread
// block, in which thread (tr, tc) = (threadIdx.x / 16, threadIdx.x % 16)
// owns rows 4·tr .. 4·tr+3 of a 64×64 product and its columns tc + 16·j,
// or, of a 64×HD accumulator, the columns 64·f + 4·tc .. +3.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // query rows per tile
constexpr int kBK = 64;                 // keys per tile
constexpr int kPadP = kBK + 4;          // row stride of a 64×64 tile (floats)
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages kBQ rows of every operand");

// row stride of a staged [64][HD] tile: padded by 4 floats so that the
// float4 reads of neighbouring rows spread over the banks
__host__ __device__ constexpr int ld_of(int hd) { return hd + 4; }

__device__ __forceinline__ float4 to_f32x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One tile of kBQ rows (row stride `stride` elements) into shared memory
// [kBQ][LD]; rows at or past `valid` are zero-filled, so that a masked
// lane (p = 0) never meets a stale value.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int valid) {
  constexpr int kPerRow = HD / 4;                 // float4 loads a row
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float* out = dst + r * ld_of(HD) + c;
    if (r >= valid) {
      *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    *reinterpret_cast<float4*>(out) =
        *reinterpret_cast<const float4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// s[i][j] = Σ_d a[4·tr + i][d] · b[tc + 16·j][d] over two staged [64][HD]
// tiles (q·kᵀ, do·vᵀ and their transposes), in float32, d in order
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a_s,
                                         const float* b_s, int tr, int tc) {
  constexpr int LD = ld_of(HD);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = to_f32x4(a_s + (4 * tr + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = to_f32x4(b_s + (tc + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(aa[i].x, bb[j].x, x);
        x = fmaf(aa[i].y, bb[j].y, x);
        x = fmaf(aa[i].z, bb[j].z, x);
        s[i][j] = fmaf(aa[i].w, bb[j].w, x);
      }
  }
}

// acc[i][c] += Σ_kk p[4·tr + i][kk] · b[kk][col(c)] for a [64][kPadP] tile
// p and a staged [64][HD] tile b (p·v, dS·k, Pᵀ·do, dSᵀ·q), kk in order
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16],
                                         const float* p_s, const float* b_s,
                                         int tr, int tc) {
  constexpr int LD = ld_of(HD);
  constexpr int kCols = HD / 16;
#pragma unroll 2
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = to_f32x4(p_s + (4 * tr + i) * kPadP + kk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int f = 0; f < kCols / 4; ++f) {
        const float4 vb = to_f32x4(b_s + (kk + t) * LD + 64 * f + 4 * tc);
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
}

// Row `r` (< 64) of a 4-row × HD/16 accumulator patch, times `mul`, to
// dst[64·f + 4·tc ..]
template <int HD>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&row)[HD / 16],
                                          float mul, int tc) {
#pragma unroll
  for (int f = 0; f < HD / 64; ++f)
    store4(dst + 64 * f + 4 * tc, row[4 * f] * mul, row[4 * f + 1] * mul,
           row[4 * f + 2] * mul, row[4 * f + 3] * mul);
}

}  // namespace flash
