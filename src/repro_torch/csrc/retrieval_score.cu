// MIND multi-interest retrieval scores (kernel 10).
//
// Replaces the Pallas kernel
//   src/repro/kernels/retrieval_score.py::retrieval_score
//   (body _score_kernel): score[c] = max_i <cands[c], interests[i]> for
//   cands [C, D] and interests [I, D], float32, out [C] float32.
//
// Bound on an H100 (3.35 TB/s): each candidate row is read once and used
// for I dot products, 2·I·D flops per 4·D bytes, so at I = 4 the call does
// 2 flops per byte against the card's ~20 (67 TFLOP/s float32 over
// 3.35 TB/s): it is bound by bytes. At the retrieval cell's call
// (C = 1,000,448, D = 64, I = 4) it must read 256.1 MB and write 4.0 MB:
// 78 us.
//
// Design: a group of 16 lanes (half a warp) per candidate row, so one
// 256-byte row at D = 64 is one 16-byte load per lane. The grid is
// persistent (as many blocks of 256 threads as fit on the card at once):
// each block stages the interests (I·D floats, 1 KiB at I = 4, D = 64) in
// shared memory once, then its half-warps walk the rows, kRows rows per
// step with all their loads issued before the arithmetic, so each lane
// keeps kRows 16-byte loads in flight. Each lane keeps kGroup = 4 partial
// dot products per row in registers (MIND's 4 interests); a butterfly
// shuffle inside the half warp sums them, then the max over interests is
// taken. Interests past 4 are done in further passes over the rows
// (L1-resident by then). Rows
// use float4 loads when D % 4 == 0 and the base is 16-byte aligned,
// scalar loads otherwise. The TPU kernel's pad-to-2048 row blocks have no
// purpose here: the walk masks the ragged end. The products are true
// float32 FMAs (no tensor cores, no TF32); NaN propagates through the max
// as in the reference.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                    // lanes per row
constexpr int kHalves = kThreads / kLanes;    // rows a block works on at once
constexpr int kRows = 4;                      // rows per half-warp per step
constexpr int kGroup = 4;                     // interests per pass

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, kLanes);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One step: rows r[j] (live[j] false past the end) against interests
// g0 .. g0 + ng - 1 (ng <= kGroup); folds each row's max into best[j].
template <bool kVec>
__device__ __forceinline__ void score_rows(const float* __restrict__ cands,
                                           const float* w, const int64_t* r,
                                           const bool* live, int d, int lane,
                                           int g0, int ng, float* best) {
  float acc[kRows][kGroup];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc[j][g] = 0.f;
  if (kVec) {
    const int d4 = d / 4;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int c = lane; c < d4; c += kLanes) {
      float4 v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        v[j] = live[j] ? __ldg(reinterpret_cast<const float4*>(
                             cands + r[j] * d) + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g < ng) {
          const float4 u = w4[(g0 + g) * d4 + c];
#pragma unroll
          for (int j = 0; j < kRows; ++j) acc[j][g] = dot4(v[j], u, acc[j][g]);
        }
      }
    }
  } else {
    for (int c = lane; c < d; c += kLanes) {
      float v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        v[j] = live[j] ? __ldg(cands + r[j] * d + c) : 0.f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g < ng) {
          const float u = w[(g0 + g) * d + c];
#pragma unroll
          for (int j = 0; j < kRows; ++j) acc[j][g] = fmaf(v[j], u, acc[j][g]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float s = half_warp_sum(acc[j][g]);
      if (g < ng) best[j] = max_nan(best[j], s);
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    retrieval_score_kernel(const float* __restrict__ cands,
                           const float* __restrict__ interests,
                           float* __restrict__ out, int64_t rows, int d,
                           int n_int) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const int total = n_int * d;
  for (int i = threadIdx.x; i < total; i += kThreads) w[i] = interests[i];
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  // the walk is uniform over each warp (both halves take the same steps),
  // so the shuffles always have all 32 lanes
  const int64_t halves = static_cast<int64_t>(gridDim.x) * kHalves;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kHalves + threadIdx.x / kLanes;
  const int64_t warp_first = first - (threadIdx.x / kLanes) % 2;
  for (int64_t base = 0; warp_first + base < rows; base += halves * kRows) {
    int64_t r[kRows];
    bool live[kRows];
    float best[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      r[j] = first + base + j * halves;
      live[j] = r[j] < rows;
      best[j] = -INFINITY;
    }
    for (int g0 = 0; g0 < n_int; g0 += kGroup)
      score_rows<kVec>(cands, w, r, live, d, lane, g0,
                       min(kGroup, n_int - g0), best);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (live[j]) out[r[j]] = best[j];
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* cands, const float* interests, float* out,
                   int64_t rows, int d, int n_int, int smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        retrieval_score_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, retrieval_score_kernel<kVec>, kThreads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once, no more than the rows need
  const int64_t need = (rows + kHalves * kRows - 1) / (kHalves * kRows);
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(need < fill ? need : fill);
  retrieval_score_kernel<kVec><<<blocks, kThreads, smem, stream>>>(
      cands, interests, out, rows, d, n_int);
  return cudaGetLastError();
}

}  // namespace

// max_smem: the shared memory a block may opt in to on this device; the
// interests (4·I·D bytes) must fit in it.
extern "C" int reach_retrieval_score(const float* cands,
                                     const float* interests, float* out,
                                     int64_t rows, int d, int n_int,
                                     int max_smem, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int64_t smem = static_cast<int64_t>(d) * n_int * 4;
  if (d < 1 || n_int < 1 || smem > max_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(cands) % 16 == 0;
  const int sm = static_cast<int>(smem);
  const cudaError_t err =
      vec ? launch<true>(cands, interests, out, rows, d, n_int, sm, stream)
          : launch<false>(cands, interests, out, rows, d, n_int, sm, stream);
  return static_cast<int>(err);
}
