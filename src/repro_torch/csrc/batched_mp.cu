// Batched dense message passing (kernel 9, the route for larger graphs).
//
// Replaces the Pallas kernel
//   src/repro/kernels/batched_mp.py::batched_mp
//   (body _mp_kernel): out[b] = (adj[b] @ x[b]) @ w for adj [B, N, N],
//   x [B, N, F], w [F, H], float32, out [B, N, H] float32. The GNN's
//   dense-batch (molecule) forward calls it once per layer; its graphs
//   (N <= 64, F, H <= 128) take the tensor-core kernel in
//   batched_mp_mma.cu, and this one takes every other shape
//   (kernels/batched_mp.py::route).
//
// Bound on an H100: each graph does 2·N·N·F + 2·N·F·H flops on
// 4·(N·N + N·F + N·H) bytes (w is shared by all graphs). At the molecule
// shape (N = 30, F = H = 64) that is 361 kflop per 19.0 kB, 19 flops per
// byte against the card's 20 (67 TFLOP/s float32 over 3.35 TB/s): the two
// bounds are about equal. A bulk batch of 65,536 molecules must move
// 1.25 GB (0.37 ms) and do 23.7 GFLOP (0.35 ms).
//
// Design: one block per (graph, RT-row tile of adj, HT-column tile of H).
// The block stages its rows adj[b][rows, :] [RT, N] in shared memory once,
// then walks F in tiles of FT columns: it stages x[b][:, tile] [N, FT] and
// the matching rows of w [FT, HT], computes agg = adj[rows] @ x[:, tile]
// [RT, FT] into shared memory, and adds agg @ w[tile, htile] into an
// [RT, HT] accumulator in shared memory, written out at the end: 4·(RT·N +
// N·FT + RT·FT + FT·HT + RT·HT) bytes. Threads walk the outputs in row
// order, so a warp reads one row of adj (or agg) as a broadcast and
// neighbouring columns of x (or w) without bank conflicts. The TPU kernel
// holds the whole graph in VMEM (16 MiB); a block has at most 227 KB of
// shared memory, so the wrapper (kernels/batched_mp.py::tiles) keeps RT =
// N whenever the whole adj fits beside some F and H tiles, and cuts FT,
// then HT, as before (at N = 128, F = H = 128 the whole block would need
// 320 KB and FT = 64 fits in 224 KB); beyond that it cuts FT to 8 and RT
// until the row tile fits (N = 1024: RT 32, FT 8, 171 KB). The row and H
// tiles of a graph share grid.y (at most 65,535), which holds N up to
// 6,448 at F = H = 64; the wrapper refuses larger graphs. When HT < H
// each H tile recomputes its agg rows; every row tile reads all of x[b]
// again. Sums are true float32 FMAs in order of the reduced index (no
// tensor cores, no TF32), the same order for any RT. adj @ x runs them in
// sums of kChunk = 256 terms, added in turn: one sum up to N 256, which
// covers every graph whose whole adj fits a block; beyond, one running
// sum over all N would round more than the plain einsum's blocked sums.
// Each FMA reads two shared-memory words, so the kernel is bound by
// shared-memory bandwidth well before the FP32 peak (on an H100, 3.3 ms
// at the molecule bulk call against 0.61 ms for batched_mp_mma.cu).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// terms of adj @ x summed in one running sum before it joins the total
constexpr int kChunk = 256;

__global__ void __launch_bounds__(kThreads)
    batched_mp_kernel(const float* __restrict__ adj,
                      const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      int n, int f, int h, int rt, int ft, int ht,
                      int h_tiles) {
  extern __shared__ float sm[];
  float* a_s = sm;               // [rt, n]   this tile's rows of adj
  float* x_s = a_s + rt * n;     // [n, ft]
  float* g_s = x_s + n * ft;     // [rt, ft]  agg tile
  float* w_s = g_s + rt * ft;    // [ft, ht]
  float* o_s = w_s + ft * ht;    // [rt, ht]  accumulator
  const int64_t b = blockIdx.x;
  const int r0 = (blockIdx.y / h_tiles) * rt;
  const int h0 = (blockIdx.y % h_tiles) * ht;
  const int rw = min(rt, n - r0);
  const int hw = min(ht, h - h0);
  const float* adj_b = adj + (b * n + r0) * n;
  const float* x_b = x + b * n * f;
  float* out_b = out + (b * n + r0) * h;

  for (int i = threadIdx.x; i < rw * n; i += kThreads) a_s[i] = adj_b[i];
  for (int i = threadIdx.x; i < rw * hw; i += kThreads) o_s[i] = 0.f;
  for (int f0 = 0; f0 < f; f0 += ft) {
    const int fw = min(ft, f - f0);
    for (int i = threadIdx.x; i < n * fw; i += kThreads)
      x_s[i] = x_b[(i / fw) * f + f0 + i % fw];
    for (int i = threadIdx.x; i < fw * hw; i += kThreads)
      w_s[i] = w[(f0 + i / hw) * h + h0 + i % hw];
    __syncthreads();
    for (int i = threadIdx.x; i < rw * fw; i += kThreads) {
      const float* a_row = a_s + (i / fw) * n;
      const float* x_col = x_s + i % fw;
      float acc = 0.f;
      for (int m0 = 0; m0 < n; m0 += kChunk) {
        const int m1 = min(n, m0 + kChunk);
        float part = 0.f;
        for (int m = m0; m < m1; ++m)
          part = fmaf(a_row[m], x_col[m * fw], part);
        acc = m0 ? acc + part : part;
      }
      g_s[i] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rw * hw; i += kThreads) {
      const float* g_row = g_s + (i / hw) * fw;
      const float* w_col = w_s + i % hw;
      float acc = o_s[i];
      for (int k = 0; k < fw; ++k) acc = fmaf(g_row[k], w_col[k * hw], acc);
      o_s[i] = acc;
    }
    __syncthreads();
  }
  // each thread writes the accumulator entries it alone updated
  for (int i = threadIdx.x; i < rw * hw; i += kThreads)
    out_b[(i / hw) * h + h0 + i % hw] = o_s[i];
}

}  // namespace

// The shared memory a block may opt in to on `device`, in bytes (0 on
// error): the wrapper sizes the row, F and H tiles to fit it.
extern "C" int reach_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

extern "C" int reach_batched_mp(const float* adj, const float* x,
                                const float* w, float* out, int64_t graphs,
                                int n, int f, int h, int rt, int ft, int ht,
                                cudaStream_t stream) {
  if (graphs <= 0) return 0;
  if (n < 1 || f < 1 || h < 1 || rt < 1 || rt > n || ft < 1 || ft > f ||
      ht < 1 || ht > h || graphs > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem =
      4 * (static_cast<int64_t>(rt) * n + static_cast<int64_t>(n) * ft +
           static_cast<int64_t>(rt) * ft + static_cast<int64_t>(ft) * ht +
           static_cast<int64_t>(rt) * ht);
  const int64_t h_tiles = (h + ht - 1) / ht;
  const int64_t tiles = (n + rt - 1) / rt * h_tiles;
  if (tiles > 65535 || smem > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        batched_mp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(graphs),
                  static_cast<unsigned>(tiles));
  batched_mp_kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      adj, x, w, out, n, f, h, rt, ft, ht, static_cast<int>(h_tiles));
  return static_cast<int>(cudaGetLastError());
}
