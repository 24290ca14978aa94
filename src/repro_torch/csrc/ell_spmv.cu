// ELL sparse matrix x dense vector, y[n] = sum_k vals_t[k][n] * x[cols_t[k][n]].
//
// Replaces: src/repro/kernels/spmv/kernel.py:ell_mulsum (the multiply-
// reduce) together with the XLA gather x[cols] that ran before it
// (src/repro/kernels/spmv/ops.py:ell_matvec). The TPU has no lane gather,
// so the JAX package gathered outside the kernel and wrote the gathered
// (K, N) operand to memory; Hopper gathers in the kernel, and that
// intermediate never exists.
//
// What bounds it on the H100: bytes. Each of the K*N slots reads a value
// (4 B f32, 2 B bf16) and a column index (4 B) once, x is gathered through
// the read-only path (its 600 KB fit in the 50 MB L2), and y is written
// once: about one flop per 4-6 bytes, far below the card's balance point.
//
// Design: one thread per row n over the K-major ("ELL-T") layout, so a
// warp's 32 threads read 32 neighbouring slots of one k: every vals/cols
// load is a 128-byte coalesced line. x[cols] goes through __ldg. The sum
// is float32 in k order 0..K-1. Column indices must lie in [0, nx): the
// kernel does not check them. A bad index has no one meaning to copy:
// the plain version raises on it, the JAX gather wraps negative ones
// and clamps the rest. The distributed SpMV checks its columns once,
// when it builds the matrix. No shared memory, nothing staged:
// the simple kernel comes first; vector loads and cp.async staging of x
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const uint16_t* p) {
  // bfloat16 is the top half of a float32.
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ vals_t,
                                const int32_t* __restrict__ cols_t,
                                const T* __restrict__ x,
                                float* __restrict__ y,
                                int K, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const size_t off = static_cast<size_t>(k) * N + n;
    const int c = __ldg(cols_t + off);
    acc += load_f(vals_t + off) * load_f(x + c);
  }
  y[n] = acc;
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* vals_t, const void* cols_t, const void* x,
                   void* y, int K, int N, void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  ell_spmv_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals_t), static_cast<const int32_t*>(cols_t),
      static_cast<const T*>(x), static_cast<float*>(y), K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals_t, const void* cols_t, const void* x,
                 void* y, int K, int N, void* stream) {
  return static_cast<int>(
      launch<float>(vals_t, cols_t, x, y, K, N, stream));
}

int ell_spmv_bf16(const void* vals_t, const void* cols_t, const void* x,
                  void* y, int K, int N, void* stream) {
  return static_cast<int>(
      launch<uint16_t>(vals_t, cols_t, x, y, K, N, stream));
}

}  // extern "C"
