// One flash attention backward call (kernels 7 and 8), as the C entry
// points in flash_attention_bwd.cu check it and hand it to either kernel
// family: the float32 kernels there or the bfloat16 ones in
// flash_bwd_wgmma.cu. q, dout [B, Sq, H, hd] and k, v [B, Sk, KV, hd] of
// one type, contiguous and 16-byte aligned, KV dividing H; lse and delta
// [B, H, Sq] float32.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

struct FlashBwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, heads, kv_heads, sq, sk, hd, causal;
  int64_t q_offset;
  cudaStream_t stream;
};

// flash_bwd_wgmma.cu: the bfloat16 kernels. dq [B, Sq, H, hd] and dk, dv
// [B, Sk, KV, hd] bf16 for outputs; hd 64 or 128, else an error.
cudaError_t flash_bwd_dq_wgmma(const FlashBwdArgs& a, void* dq);
cudaError_t flash_bwd_dkv_wgmma(const FlashBwdArgs& a, void* dk, void* dv);
// The shared memory one block of them takes at head dim `hd` (kernel 7:
// dkv == 0, kernel 8: dkv != 0), in bytes; -1 for another hd.
int flash_bwd_wgmma_smem(int hd, int dkv);
