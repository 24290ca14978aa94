// Narrow-band ELL sparse matrix x dense vector with window-relative
// columns: for row n of row block b = n / block_r,
//   y[n] = sum_k vals_t[k][n] * x_pad[b*block_r + cols_win_t[k][n]],
// where a column outside [0, W) contributes 0, W = 2*hb + block_r.
//
// Replaces: src/repro/kernels/spmv/kernel.py:ell_onehot_mv (body
// _onehot_body). The TPU has no lane gather, so that kernel gathered
// each row's x entry as a one-hot (block_r, W) x (W,) matmul per k
// against the block's window of wrap-padded x, and the JAX wrapper built
// an (N/block_r, W) copy of overlapping windows for it. On Hopper one CTA
// per row block stages its window x_pad[b*block_r : b*block_r + W] in
// shared memory and indexes it directly; the window copy and the one-hot
// products do not exist. A column outside the window gives 0, as a
// one-hot row with no match did.
//
// What bounds it on the H100: bytes. Each of the K*N slots reads a value
// and a window-relative column once (8 B), the window of x is read once
// per block (W/block_r words per row), y is written once: well under one
// flop per byte.
//
// Design: one thread per row, block_r threads per CTA (at most 1024), the
// K-major layout so every vals/cols load is coalesced across the warp, a
// float32 sum in k order 0..K-1. Shared memory holds W floats; the
// wrapper refuses a window larger than the 227 KB a CTA can opt into
// (this is the narrow-band kernel: W <~ 1024 is its range).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit

__global__ void ell_onehot_kernel(const float* __restrict__ vals_t,
                                  const int32_t* __restrict__ cols_win_t,
                                  const float* __restrict__ x_pad,
                                  float* __restrict__ y, int K, int N,
                                  int W) {
  extern __shared__ float xs[];
  const int start = blockIdx.x * blockDim.x;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    xs[i] = __ldg(x_pad + start + i);
  __syncthreads();
  const int n = start + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const size_t off = static_cast<size_t>(k) * N + n;
    const int c = __ldg(cols_win_t + off);
    if (c >= 0 && c < W) acc += __ldg(vals_t + off) * xs[c];
  }
  y[n] = acc;
}

}  // namespace

extern "C" {

// vals_t, cols_win_t (K, N) with N a multiple of block_r; x_pad holds at
// least N - block_r + W floats; y (N,).
int ell_onehot_f32(const void* vals_t, const void* cols_win_t,
                   const void* x_pad, void* y, int K, int N, int W,
                   int block_r, void* stream) {
  if (block_r < 1 || block_r > 1024 || N % block_r != 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(W);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (N == 0) return static_cast<int>(cudaSuccess);
  ell_onehot_kernel<<<N / block_r, block_r, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals_t),
      static_cast<const int32_t*>(cols_win_t),
      static_cast<const float*>(x_pad), static_cast<float*>(y), K, N, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
