// Pack (gather) of send buffers: out[j] = x[idx[j]], and 0 where idx[j]
// lies outside [0, n).
//
// Replaces: src/repro/kernels/pack/kernel.py:pack. The TPU has no lane
// gather, so the JAX kernel streamed x through VMEM in chunks and summed
// one-hot (block_c, chunk) matmuls: O(m * n) multiply-adds for m outputs.
// Hopper gathers directly; the one-hot products and chunk have no
// counterpart here, and block_c becomes the outputs per CTA. Padded
// slots (idx = -1) give 0 as they did there.
//
// What bounds it on the H100: bytes. It reads idx (4 B) and one element
// of x per output and writes one element: no arithmetic at all.
//
// Design: one thread per output j. idx loads and out stores are
// coalesced across the warp; the x reads are as scattered as idx makes
// them and go through __ldg. The kernel moves raw 2- or 4-byte words,
// so it serves float32 and bfloat16 alike and copies bits exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void pack_kernel(const W* __restrict__ x,
                            const int32_t* __restrict__ idx,
                            W* __restrict__ out, int n, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int i = __ldg(idx + j);
  out[j] = (i >= 0 && i < n) ? __ldg(x + i) : W(0);
}

// threads = outputs per CTA (the autotune grid's block_c; 256 by
// default). The TPU kernel's chunk (the one-hot x-chunk) has no
// counterpart here.
template <typename W>
cudaError_t launch(const void* x, const void* idx, void* out, int n, int m,
                   int threads, void* stream) {
  const int blocks = (m + threads - 1) / threads;
  pack_kernel<W><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<const int32_t*>(idx),
      static_cast<W*>(out), n, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 4-byte elements (float32).
int pack_b32(const void* x, const void* idx, void* out, int n, int m,
             int threads, void* stream) {
  return static_cast<int>(launch<uint32_t>(x, idx, out, n, m, threads, stream));
}

// 2-byte elements (bfloat16).
int pack_b16(const void* x, const void* idx, void* out, int n, int m,
             int threads, void* stream) {
  return static_cast<int>(launch<uint16_t>(x, idx, out, n, m, threads, stream));
}

}  // extern "C"
