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
// flop per byte. With every CTA of the paper's band resident at once
// (586 CTAs of 256 threads on 132 SMs), what it pays beyond the launch
// is round trips to memory, and the design takes them all at once
// rather than in series (the window, then a column, then the value that
// the column selects):
//
// - The window arrives by a TMA bulk copy (cp.async.bulk, completing on
//   an mbarrier in shared memory) that one thread issues first; every
//   thread then issues all 2K loads of its row's columns and values into
//   registers, and only then waits for the window. The copy needs 16-byte
//   aligned addresses and a multiple of 16 bytes: the window sits in
//   shared memory at the same offset from a 16-byte boundary as in
//   global memory, the aligned body goes by TMA, and the at most 3 head
//   and 3 tail words by plain loads (never a word outside the window).
// - No load waits on another: values load unconditionally and the window
//   test predicates the gather from shared memory and the FMA, so a slot
//   outside the window adds exactly nothing (not 0 * x, which is NaN for
//   an Inf in x_pad).
// - K is a template argument for K = 1..16, so all 2K loads of a row
//   issue back to back; a larger K takes a runtime loop after its first
//   16 slots.
//
// Two rows or four a thread, with 8- or 16-byte loads along N, measured
// no faster on the H100 (PERF.md) and were left out.
//
// One thread per row, block_r threads per CTA (at most 1024), the
// K-major layout so every load is coalesced across the warp, a float32
// sum in k order 0..K-1, one FMA per slot in the window. Shared memory
// holds the barrier and W + 3 floats; the wrapper refuses a window
// larger than the 227 KB a CTA can opt into (this is the narrow-band
// kernel: W <~ 1024 is its range).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit
constexpr int kUnrolledK = 16;          // K = 1..16 are instantiated
constexpr int kBarrierBytes = 16;       // the mbarrier, padded to 16 B
// A window that has not arrived after this many polls of its barrier
// (seconds) traps instead of hanging the card.
constexpr uint32_t kMaxPolls = 1u << 26;

size_t smem_bytes(int W) {
  return kBarrierBytes + sizeof(float) * (static_cast<size_t>(W) + 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool barrier_done(uint32_t bar, uint32_t phase) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(phase)
      : "memory");
  return done != 0;
}

// KT > 0: K == KT, every slot's loads unrolled. KT == 0: any K, the
// first kUnrolledK slots as above, the rest in a loop.
template <int KT>
__global__ void __launch_bounds__(1024)
    ell_onehot_kernel(const float* __restrict__ vals_t,
                      const int32_t* __restrict__ cols_win_t,
                      const float* __restrict__ x_pad,
                      float* __restrict__ y, int K, int N, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int tid = static_cast<int>(threadIdx.x);
  const int threads = static_cast<int>(blockDim.x);
  const int start = blockIdx.x * threads;
  const float* win = x_pad + start;
  // buf[s + i] holds win[i]: buf and global memory agree modulo 16 bytes.
  const int s = static_cast<int>((reinterpret_cast<uintptr_t>(win) >> 2) & 3);
  const int body_lo = (s + 3) & ~3, body_hi = (s + W) & ~3;
  const bool bulk = body_hi > body_lo;
  // Plain loads: the head buf[s, lo) and the tail buf[hi, s + W).
  const int lo = bulk ? body_lo : s + W, hi = bulk ? body_hi : s + W;
  const int n_head = lo - s, n_plain = n_head + (s + W - hi);
  const uint32_t bar_a = smem_u32(bar);

  if (bulk && tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(body_hi - body_lo) * 4u;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar_a), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(buf + body_lo)),
        "l"(win + (body_lo - s)), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  int plain_j = -1;
  float plain_x = 0.0f;
  if (tid < n_plain) {
    plain_j = tid < n_head ? s + tid : hi + (tid - n_head);
    plain_x = __ldg(win + (plain_j - s));
  }
  for (int p = tid + threads; p < n_plain; p += threads) {
    const int j = p < n_head ? s + p : hi + (p - n_head);
    buf[j] = __ldg(win + (j - s));
  }

  // N is a multiple of blockDim.x: every thread has a row.
  const int n = start + tid;
  constexpr int R = KT > 0 ? KT : kUnrolledK;
  int c[R];
  float v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (KT > 0 || k < K) {
      const size_t off = static_cast<size_t>(k) * N + n;
      c[k] = __ldg(cols_win_t + off);
      v[k] = __ldg(vals_t + off);
    } else {
      c[k] = -1;
      v[k] = 0.0f;
    }
  }

  if (plain_j >= 0) buf[plain_j] = plain_x;
  __syncthreads();  // the plain words, and the barrier's initialisation
  if (bulk) {
    for (uint32_t polls = 0; !barrier_done(bar_a, 0);)
      if (++polls == kMaxPolls) __trap();
  }

  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (static_cast<unsigned>(c[k]) < static_cast<unsigned>(W))
      acc += v[k] * buf[s + c[k]];
  if (KT == 0) {
    for (int k = R; k < K; ++k) {
      const size_t off = static_cast<size_t>(k) * N + n;
      const int ck = __ldg(cols_win_t + off);
      const float vk = __ldg(vals_t + off);
      if (static_cast<unsigned>(ck) < static_cast<unsigned>(W))
        acc += vk * buf[s + ck];
    }
  }
  y[n] = acc;
}

template <int KT>
int launch(const float* vals_t, const int32_t* cols_win_t,
           const float* x_pad, float* y, int K, int N, int W, int block_r,
           cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_onehot_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  ell_onehot_kernel<KT><<<N / block_r, block_r, smem_bytes(W), stream>>>(
      vals_t, cols_win_t, x_pad, y, K, N, W);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int dispatch(int K, const float* vals_t, const int32_t* cols_win_t,
             const float* x_pad, float* y, int N, int W, int block_r,
             cudaStream_t stream) {
  if (K == KT)
    return launch<KT>(vals_t, cols_win_t, x_pad, y, K, N, W, block_r,
                      stream);
  if constexpr (KT < kUnrolledK)
    return dispatch<KT + 1>(K, vals_t, cols_win_t, x_pad, y, N, W, block_r,
                            stream);
  else
    return launch<0>(vals_t, cols_win_t, x_pad, y, K, N, W, block_r,
                     stream);
}

}  // namespace

extern "C" {

// vals_t, cols_win_t (K, N) with N a multiple of block_r; x_pad holds at
// least N - block_r + W floats; y (N,).
int ell_onehot_f32(const void* vals_t, const void* cols_win_t,
                   const void* x_pad, void* y, int K, int N, int W,
                   int block_r, void* stream) {
  if (block_r < 1 || block_r > 1024 || N % block_r != 0 || W < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(W) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  return dispatch<1>(K, static_cast<const float*>(vals_t),
                     static_cast<const int32_t*>(cols_win_t),
                     static_cast<const float*>(x_pad), static_cast<float*>(y),
                     N, W, block_r, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
