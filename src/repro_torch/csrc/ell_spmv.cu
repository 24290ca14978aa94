// ELL sparse matrix x dense vector,
// y[n] = sum_k vals_t[k][n] * x[cols_t[k][n]], over the plain ELL-T
// layout or the sorted-slice one (SELL-32-window).
//
// Replaces: src/repro/kernels/spmv/kernel.py:ell_mulsum (the multiply-
// reduce) together with the XLA gather x[cols] that ran before it
// (src/repro/kernels/spmv/ops.py:ell_matvec). The TPU has no lane gather,
// so the JAX package gathered outside the kernel and wrote the gathered
// (K, N) operand to memory; Hopper gathers in the kernel, and that
// intermediate never exists.
//
// What bounds it on the H100: neither the bytes nor a chain of dependent
// loads (measured on the paper's matrix, PERF.md). Each slot read
// moves a value (4 B f32, 2 B bf16) and a column (4 B) once, and y is
// written once: about one flop per 4-6 bytes, a byte bound of a few us.
// Between CUDA events a launch takes several times that. About a third
// of it is the launch itself (an empty kernel of the same grid), and a
// large part of the rest is the gathers of x: every non-zero reads 4
// bytes of a line that no other lane of its warp touches. Fewer trips
// per thread would not help: nvcc had already unrolled the
// one-thread-per-row loop this kernel replaced by 16, 8 and 4, with its
// loads batched.
//
// Design:
// - One warp per 32-row slice, lane = row. The wrapper makes block_n (the
//   CTA's threads) a multiple of 32, so warp w of CTA b is slice
//   (b * block_n) / 32 + w. For each k the warp reads one 128-byte line of
//   cols_t and one of vals_t (64 bytes at bf16).
// - A slice stops at its widest row, slice_k[s] (K when slice_k is null).
//   The sorted layout (repro_torch/kernels/spmv/ops.py:sliced_operands)
//   puts rows of nearly equal length into a slice, so on the paper's
//   matrix the slots read fall from 2.0x to about 1.03x the non-zeros.
// - The gathers: the distributed SpMV deals its CTAs' row blocks out
//   rank by rank (ops.py:deal_blocks), so the CTAs that the card places
//   on one SM gather from one rank's part of x, which its L1 holds.
// - k runs in chunks of kChunk = 4 slots, unrolled: a thread first issues
//   the chunk's 8 cols_t and vals_t loads, then its 4 x gathers, then the
//   FMAs. Slots past the row's slice width are predicated off. Chunks of
//   8 and 16 took more registers and were not faster.
// - The row's perm entry is loaded with slice_k, before the slots, so
//   the store waits on no trip of its own.
// - The float32 sum runs in k order 0..len-1 with fmaf, as before: the
//   slots that a slice skips hold 0, so on finite x the result is the
//   padded kernel's, bit for bit.
// - Sorted row n is written to y[perm[n]] (y[n] when perm is null).
// Column indices of the slots read must lie in [0, nx): the kernel does
// not check them. A bad index has no one meaning to copy: the plain
// version raises on it, the JAX gather wraps negative ones and clamps
// the rest. The distributed SpMV checks its columns once, at set-up.
// slice_k entries are clamped to [0, K]. No shared memory: each value of
// vals_t and cols_t is read once, and x is reached through L1 and L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const uint16_t* p) {
  // bfloat16 is the top half of a float32.
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ vals_t,
                                const int32_t* __restrict__ cols_t,
                                const T* __restrict__ x,
                                const int32_t* __restrict__ slice_k,
                                const int32_t* __restrict__ perm,
                                float* __restrict__ y, int K, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int dst = perm == nullptr ? n : __ldg(perm + n);
  const int len = slice_k == nullptr
                      ? K
                      : min(max(__ldg(slice_k + (n >> 5)), 0), K);
  const size_t stride = static_cast<size_t>(N);
  const T* vp = vals_t + n;
  const int32_t* cp = cols_t + n;
  float acc = 0.0f;
  for (int k0 = 0; k0 < len; k0 += kChunk) {
    int c[kChunk];
    float v[kChunk], g[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      c[j] = 0;
      v[j] = 0.0f;
      if (k0 + j < len) {
        const size_t off = static_cast<size_t>(k0 + j) * stride;
        c[j] = __ldg(cp + off);
        v[j] = load_f(vp + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      g[j] = 0.0f;
      if (k0 + j < len) g[j] = load_f(x + c[j]);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (k0 + j < len) acc = fmaf(v[j], g[j], acc);
    }
  }
  y[dst] = acc;
}

// blocks x threads from the wrapper (threads = block_n, a multiple of 32).
template <typename T>
cudaError_t launch(const void* vals_t, const void* cols_t, const void* x,
                   const void* slice_k, const void* perm, void* y, int K,
                   int N, int blocks, int threads, void* stream) {
  ell_spmv_kernel<T><<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals_t), static_cast<const int32_t*>(cols_t),
      static_cast<const T*>(x), static_cast<const int32_t*>(slice_k),
      static_cast<const int32_t*>(perm), static_cast<float*>(y), K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals_t, const void* cols_t, const void* x,
                 const void* slice_k, const void* perm, void* y, int K,
                 int N, int blocks, int threads, void* stream) {
  return static_cast<int>(launch<float>(vals_t, cols_t, x, slice_k, perm,
                                        y, K, N, blocks, threads, stream));
}

int ell_spmv_bf16(const void* vals_t, const void* cols_t, const void* x,
                  const void* slice_k, const void* perm, void* y, int K,
                  int N, int blocks, int threads, void* stream) {
  return static_cast<int>(launch<uint16_t>(vals_t, cols_t, x, slice_k,
                                           perm, y, K, N, blocks, threads,
                                           stream));
}

}  // extern "C"
