// Batched dense message passing on the tensor cores (kernel 9, the route
// for small graphs).
//
// Replaces the Pallas kernel
//   src/repro/kernels/batched_mp.py::batched_mp
//   (body _mp_kernel): out[b] = (adj[b] @ x[b]) @ w for adj [B, N, N],
//   x [B, N, F], w [F, H], float32, out [B, N, H] float32, for the
//   molecule regime: N <= 64, F <= 128, H <= 128 (kernels/batched_mp.py::
//   route). Larger graphs take the row-tiled FMA kernel in batched_mp.cu.
//
// Bound on an H100: each graph moves 4·(N·N + N·F + N·H) bytes and does
// 2·N·N·F + 2·N·F·H flops (w is shared by all graphs). At the molecule
// shape (N 30, F = H = 64) a bulk batch of 65,536 graphs must move
// 1.24 GB (0.37 ms at 3.35 TB/s); its 23.7 GFLOP take 0.35 ms on the
// FP32 cores but, padded to the tensor-core tiles and done three times
// (3xTF32, below), 77 GFLOP take 0.16 ms at the 495 TFLOP/s TF32 peak:
// on the tensor cores the kernel is bound by device memory.
//
// Design: a persistent grid, one block per SM, each block a set of
// pipelines, each pipeline a pair of warps that walks graphs b = pair,
// pair + all pairs, ... . The block stages w once, split for the tensor
// cores (below), and keeps it for all its graphs. Each pair owns a ring
// of one or two stages: graph i + 1's adj and x arrive by cp.async (16,
// 8 or 4 bytes a copy, whatever the row length and alignment allow) into
// padded rows while graph i computes; a named barrier of the pair's 64
// threads, not the block's, orders a stage's copies and its reads. Pad
// rows and columns are zeroed once: the copies write only real elements,
// so the pads stay 0 and add nothing to a sum. A pair's first copies
// start before the block stages w, so the two overlap. Each warp of a pair
// computes every other m-tile of 16 rows (at N <= 32 one each) with
// mma.sync.m16n8k8 TF32:
//   agg [16, F] = adj[rows, :] @ x        (K = N padded to 8), then
//   out [16, H] = agg @ w                 (K = F padded to 8·KF),
// keeping the reference's association. agg stays in registers: the C
// fragment of agg's n-tile j becomes the A fragment of the second
// product's k-step j when that k-step's eight columns are taken in the
// order 0, 2, 4, 6 | 1, 3, 5, 7 (the same order for w's rows), which
// changes only the order of terms within one tensor-core sum. Shared
// rows are padded so that fragment loads are free of bank conflicts:
// adj rows by N8 + 4 words (4 mod 8), x rows by 8·KF + 8 (8 mod 16), and
// w, split into float4 {big(2t), big(2t+1), small(2t), small(2t+1)} per
// (row pair, column), by H + 2 float4s, so a B fragment's four words are
// one 16-byte load.
//
// Precision: each operand is split as big = tf32(a), small = tf32(a -
// big) (round to nearest, ties away, as cvt.rna.tf32.f32; done with two
// integer ops), and a product is small·big + big·small + big·big
// (3xTF32, the small terms first), which keeps about 22 of float32's 24
// bits of each operand. The tensor cores' own float32 sums round toward
// zero, so a k-step's three products go into a fresh fragment that is
// then added, rounded to nearest, into a float32 sum: a long chain of
// products on one fragment would lose an ulp of the whole sum at each
// step. A term whose small operand is zero in the whole warp (adj of 0/1
// values; w = eye) is skipped: it adds exactly 0. Outputs go straight
// from the fragments: each quad of lanes writes one row's 32 contiguous
// bytes, so every store fills whole sectors. No atomics: each output is
// summed in a fixed order, and repeat calls give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPairs = 8;   // pipelines a block (4 at KF 16)

// the layout of one launch, the same for every block
struct MpLayout {
  int n, f, h;
  int kn;      // N padded to 8: the K of adj @ x
  int mp;      // adj rows staged: N padded to 16
  int hp;      // H padded to 8·HC
  int sa, sx;  // row strides (words) of adj and x in shared memory
  int sw4;     // row stride (float4) of the split w
  int va, vx;  // bytes per cp.async of adj and x: 16, 8 or 4
  int stage;   // words of one ring stage: adj [mp, sa] + x [kn, sx]
  int stages;  // 1 or 2
};

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  // round to nearest, ties away from zero, onto TF32's 10 mantissa bits:
  // the value cvt.rna.tf32.f32 gives for finite a
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = (small·big + big·small + big·big) from a fresh fragment, added into
// acc rounded to nearest; the big·small term only where kSmallB.
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ab,
                                     const uint32_t* as, uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (kSmallA) mma_tf32(d, as, bb0, bb1);
  if (kSmallB) mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(V));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id));
}

// The 64 threads of a pair copy `rows` contiguous rows of `row` floats
// from src into shared rows of stride `stride`, V bytes a copy.
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int row, int stride,
                                          int tid) {
  constexpr int per = V / 4;
  const int chunks = row / per;
  const int total = rows * chunks;
  const int dr = 64 / chunks, dc = 64 % chunks;
  int r = tid / chunks, c = tid % chunks;
  for (int i = tid; i < total; i += 64) {
    cp_async<V>(dst + r * stride + c * per, src + i * per);
    r += dr;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

__device__ __forceinline__ void copy_any(float* dst, const float* src,
                                         int rows, int row, int stride,
                                         int v, int tid) {
  if (v == 16) {
    copy_rows<16>(dst, src, rows, row, stride, tid);
  } else if (v == 8) {
    copy_rows<8>(dst, src, rows, row, stride, tid);
  } else {
    copy_rows<4>(dst, src, rows, row, stride, tid);
  }
}

__device__ __forceinline__ void store_pair(float* row, int col, int h,
                                           float v0, float v1) {
  if (col + 1 < h && !(h & 1)) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < h) row[col] = v0;
    if (col + 1 < h) row[col + 1] = v1;
  }
}

// agg [16, 8·KF] of m-tile mt: adj rows @ x, one fresh fragment a k-step.
template <int KF>
__device__ __forceinline__ void aggregate(float (&agg)[KF][4],
                                          const float* a_s,
                                          const float* x_s,
                                          const MpLayout& L, int mt, int g,
                                          int t) {
#pragma unroll
  for (int j = 0; j < KF; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) agg[j][q] = 0.f;
  for (int ks = 0; ks < L.kn / 8; ++ks) {
    uint32_t ab[4], as[4];
    const float* p = a_s + (mt * 16 + g) * L.sa + ks * 8 + t;
    split(p[0], ab[0], as[0]);
    split(p[8 * L.sa], ab[1], as[1]);
    split(p[4], ab[2], as[2]);
    split(p[8 * L.sa + 4], ab[3], as[3]);
    const bool small_a =
        __any_sync(0xffffffffu, (as[0] | as[1] | as[2] | as[3]) != 0u);
    const float* xr = x_s + (ks * 8 + t) * L.sx + g;
    if (small_a) {
#pragma unroll
      for (int j = 0; j < KF; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split(xr[j * 8], bb0, bs0);
        split(xr[4 * L.sx + j * 8], bb1, bs1);
        mma3<true, true>(agg[j], ab, as, bb0, bb1, bs0, bs1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KF; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split(xr[j * 8], bb0, bs0);
        split(xr[4 * L.sx + j * 8], bb1, bs1);
        mma3<false, true>(agg[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// out [16, H] of m-tile mt = agg @ w, in chunks of 8·HC columns, stored.
template <int KF, int HC, bool kSmallW>
__device__ __forceinline__ void project(const float (&agg)[KF][4],
                                        const float4* w4, float* out_b,
                                        const MpLayout& L, int mt, int g,
                                        int t) {
  for (int h0 = 0; h0 < L.hp; h0 += 8 * HC) {
    float o[HC][4];
#pragma unroll
    for (int j = 0; j < HC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KF; ++ks) {
      // agg's n-tile ks as the A fragment, columns 0,2,4,6 | 1,3,5,7
      uint32_t ab[4], as[4];
      split(agg[ks][0], ab[0], as[0]);
      split(agg[ks][2], ab[1], as[1]);
      split(agg[ks][1], ab[2], as[2]);
      split(agg[ks][3], ab[3], as[3]);
      const float4* wr = w4 + (ks * 4 + t) * L.sw4 + h0 + g;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const float4 v = wr[j * 8];
        mma3<true, kSmallW>(o[j], ab, as, __float_as_uint(v.x),
                            __float_as_uint(v.y), __float_as_uint(v.z),
                            __float_as_uint(v.w));
      }
    }
    const int row = mt * 16 + g;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int col = h0 + j * 8 + 2 * t;
      if (row < L.n)
        store_pair(out_b + row * L.h, col, L.h, o[j][0], o[j][1]);
      if (row + 8 < L.n)
        store_pair(out_b + (row + 8) * L.h, col, L.h, o[j][2], o[j][3]);
    }
  }
}

// KF: F padded to 8·KF (x's pad columns and w's pad rows are 0); HC: H in
// chunks of 8·HC columns. agg takes 4·KF registers, a chunk of out 4·HC.
template <int KF, int HC>
__global__ void __launch_bounds__(KF > 8 ? 256 : 2 * kMaxPairs * 32, 1)
    batched_mp_mma_kernel(const float* __restrict__ adj,
                          const float* __restrict__ x,
                          const float* __restrict__ w,
                          float* __restrict__ out, int64_t graphs,
                          MpLayout L) {
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                               // [4·KF, sw4]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1, tid = threadIdx.x & 63;
  const int pairs = blockDim.x >> 6;
  float* ring = reinterpret_cast<float*>(w4 + 4 * KF * L.sw4) +
                pair * L.stages * L.stage;

  const int g = lane >> 2, t = lane & 3;
  const int64_t step = static_cast<int64_t>(gridDim.x) * pairs;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * pairs + pair;

  auto issue = [&](int stage, int64_t gb) {
    float* a_s = ring + stage * L.stage;
    copy_any(a_s, adj + gb * L.n * L.n, L.n, L.n, L.sa, L.va, tid);
    copy_any(a_s + L.mp * L.sa, x + gb * L.n * L.f, L.n, L.f, L.sx, L.vx,
             tid);
  };

  // zero the pair's ring, start its first graphs' copies, and stage w
  // while they fly
  for (int i = tid; i < L.stages * L.stage; i += 64) ring[i] = 0.f;
  pair_sync(pair + 1);
  for (int s = 0; s < L.stages; ++s) {
    if (first + s * step < graphs) issue(s, first + s * step);
    cp_async_commit();
  }
  // w split for the tensor cores, zero-padded, once per block
  bool small_w = false;
  for (int i = threadIdx.x; i < 4 * KF * L.sw4; i += blockDim.x) {
    const int r = 2 * (i / L.sw4), c = i % L.sw4;
    const bool in = c < L.h;
    const float v0 = in && r < L.f ? w[r * L.h + c] : 0.f;
    const float v1 = in && r + 1 < L.f ? w[(r + 1) * L.h + c] : 0.f;
    uint32_t b0, s0, b1, s1;
    split(v0, b0, s0);
    split(v1, b1, s1);
    w4[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                        __uint_as_float(s0), __uint_as_float(s1));
    small_w |= (s0 | s1) != 0u;
  }
  small_w = __syncthreads_or(small_w);

  int it = 0;
  for (int64_t b = first; b < graphs; b += step, ++it) {
    const int stage = L.stages == 2 ? it & 1 : 0;
    if (L.stages == 2) {
      cp_async_wait<1>();   // this graph's copies have landed
    } else {
      cp_async_wait<0>();
    }
    pair_sync(pair + 1);
    const float* a_s = ring + stage * L.stage;
    const float* x_s = a_s + L.mp * L.sa;
    float* out_b = out + b * L.n * L.h;
    for (int mt = warp & 1; mt < L.mp / 16; mt += 2) {
      float agg[KF][4];
      aggregate<KF>(agg, a_s, x_s, L, mt, g, t);
      if (small_w) {
        project<KF, HC, true>(agg, w4, out_b, L, mt, g, t);
      } else {
        project<KF, HC, false>(agg, w4, out_b, L, mt, g, t);
      }
    }
    pair_sync(pair + 1);    // the stage is read: refill it
    const int64_t next = b + L.stages * step;
    if (next < graphs) issue(stage, next);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

int copy_bytes(const float* p, int row) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v > 4; v /= 2)
    if (addr % v == 0 && (row * 4) % v == 0) return v;
  return 4;
}

template <int KF, int HC>
int launch(const float* adj, const float* x, const float* w, float* out,
           int64_t graphs, const MpLayout& L, int pairs, int64_t smem,
           cudaStream_t stream) {
  auto kernel = batched_mp_mma_kernel<KF, HC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t want = (graphs + pairs - 1) / pairs;
  const unsigned blocks = static_cast<unsigned>(want < sms ? want : sms);
  kernel<<<blocks, pairs * 64, static_cast<size_t>(smem), stream>>>(
      adj, x, w, out, graphs, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel 9's tensor-core route: N <= 64, F <= 128, H <= 128, `pairs`
// pipelines of two warps a block with `stages` ring stages each (the
// wrapper's plan, kernels/batched_mp.py::mma_plan, sizes them to the
// shared memory; the layout here is the same).
extern "C" int reach_batched_mp_mma(const float* adj, const float* x,
                                    const float* w, float* out,
                                    int64_t graphs, int n, int f, int h,
                                    int pairs, int stages,
                                    cudaStream_t stream) {
  if (graphs <= 0) return 0;
  const int kf = f <= 16 ? 2 : f <= 64 ? 8 : 16;
  const int hc = h <= 16 ? 2 : 4;
  if (n < 1 || n > 64 || f < 1 || f > 128 || h < 1 || h > 128 ||
      pairs < 1 || pairs > (kf > 8 ? kMaxPairs / 2 : kMaxPairs) ||
      stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  MpLayout L;
  L.n = n;
  L.f = f;
  L.h = h;
  L.kn = round_up(n, 8);
  L.mp = round_up(n, 16);
  L.hp = round_up(h, 8 * hc);
  L.sa = L.kn + 4;
  L.sx = 8 * kf + 8;
  L.sw4 = L.hp + 2;
  L.va = copy_bytes(adj, n);
  L.vx = copy_bytes(x, f);
  L.stage = L.mp * L.sa + L.kn * L.sx;
  L.stages = stages;
  const int64_t smem =
      16 * static_cast<int64_t>(4 * kf) * L.sw4 +
      4 * static_cast<int64_t>(pairs) * stages * L.stage;
  int device = 0, limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  if (kf == 2)
    return hc == 2
               ? launch<2, 2>(adj, x, w, out, graphs, L, pairs, smem, stream)
               : launch<2, 4>(adj, x, w, out, graphs, L, pairs, smem, stream);
  if (kf == 8)
    return hc == 2
               ? launch<8, 2>(adj, x, w, out, graphs, L, pairs, smem, stream)
               : launch<8, 4>(adj, x, w, out, graphs, L, pairs, smem, stream);
  return hc == 2
             ? launch<16, 2>(adj, x, w, out, graphs, L, pairs, smem, stream)
             : launch<16, 4>(adj, x, w, out, graphs, L, pairs, smem, stream);
}
