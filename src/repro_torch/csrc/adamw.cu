// AdamW's step on one parameter leaf, in two kernels: the gradient's sum
// of squares (for the global-norm clip) and the fused update.
//
// Replaces: no Pallas kernel. The JAX package's optimizer
// (src/repro/optim/adamw.py) is jnp that XLA fuses into a few passes;
// the port's plain version (kernels/adamw/ops.py) runs it as a chain of
// PyTorch ops, each a full read and write of float32 arrays: about 140
// bytes a parameter a step.
//
// What bounds it on the H100: bytes. The clip needs every gradient seen
// once before any leaf is updated (4 B a parameter); the update reads g,
// p, mu and nu and writes p, mu and nu (28 B; 36 B with a master copy).
// At deepseek-moe-16b's 4 layers (2,770,880,512 parameters) that is
// 88.7 GB, 26.5 ms at 3.35 TB/s. There is no arithmetic to speak of: a
// few float32 operations an element.
//
// Design: each kernel reads its arrays once and keeps every intermediate
// in registers. A thread moves 16 bytes of each array at a time (4
// float32 or 8 bfloat16 elements: 8 elements a thread where any array is
// bfloat16) from a head at which every pointer is 16-byte aligned; the
// wrapper finds that head, and the elements before it and after the last
// whole vector go element by element. A grid-stride loop over at most
// 8 x 132 blocks of 256 threads (full occupancy on 132 SMs) covers a
// leaf. One launch a leaf (55 + 55 a step at 4 layers, with one launch
// that finishes the sums): a table of leaves would need the table copied
// to the card each step, or a copy of its pointers held alive, for a
// host issue of about 0.3 ms that the device's 30 ms hide.
//
// The sum of squares is deterministic: each block writes its partial
// (float64, from float64 products of the float32 values) to its own slot
// of a zeroed scratch buffer, and one block then reduces each leaf's
// slots in a fixed order and adds the leaves' float32 sums in leaf order,
// as the plain version's Python sum does. No atomics, so the same inputs
// give the same bits.
//
// The update is the reference's arithmetic in its order, in float32,
// each operation rounded as PyTorch rounds it (no contraction into fused
// multiply-adds): g *= scale; mu = b1 mu + (1 - b1) g; nu = b2 nu +
// (1 - b2) g g; u = -lr ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd a),
// with a the parameter, or its float32 master copy; then a += u, and with
// a master copy p = a rounded to p's type. scale, bc1, bc2 and lr are
// float32 scalars on the device, read by pointer: nothing in the step
// waits on the host. A null scale is the clip turned off.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// N consecutive elements from a 16-byte aligned address, as float32.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    r[j] = q.x;
    r[j + 1] = q.y;
    r[j + 2] = q.z;
    r[j + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      r[j + 2 * k] = f.x;
      r[j + 2 * k + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(p + j) =
        make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(r[j + 2 * k], r[j + 2 * k + 1]);
    *reinterpret_cast<uint4*>(p + j) = q;
  }
}

// A block's sum, in thread 0; the same order every time. Every thread
// of the block calls it.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// One leaf's sum of squares: block b's partial to partials[b]. Elements
// [head, head + nvec * N) go N at a time, the rest one by one.
template <typename TG, int N>
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const TG* __restrict__ g, int n, int head, int nvec,
                 double* __restrict__ partials) {
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  int i = t0;
  // Four vectors in flight a thread before their products are summed.
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    float r[4][N];
#pragma unroll
    for (int u = 0; u < 4; ++u) load<N>(g + head + (i + u * stride) * N, r[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const double x = r[u][j];
        acc = fma(x, x, acc);
      }
  }
  for (; i < nvec; i += stride) {
    float r[N];
    load<N>(g + head + i * N, r);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double x = r[j];
      acc = fma(x, x, acc);
    }
  }
  const int rest = n - nvec * N;
  for (int s = t0; s < rest; s += stride) {
    const double x = to_f32(g[s < head ? s : s + nvec * N]);
    acc = fma(x, x, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// One block: leaf k's float32 sum of squares (its `slots` partials
// reduced in a fixed order, warp by warp) to out[k], and the leaves'
// sums added in leaf order, from 0, to out[leaves].
__global__ void __launch_bounds__(kFinishThreads)
    sumsq_finish_kernel(const double* __restrict__ partials, int slots,
                        int leaves, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = warp; k < leaves; k += warps) {
    const double* p = partials + static_cast<long long>(k) * slots;
    double v = 0.0;
    for (int b = lane; b < slots; b += 32) v += p[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) out[k] = static_cast<float>(v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int k = 0; k < leaves; ++k) total = __fadd_rn(total, out[k]);
    out[leaves] = total;
  }
}

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

// One element: g the gradient, m and v its moments, a the parameter (or
// its master copy), updated in place.
__device__ __forceinline__ void adamw_element(float g, float& m, float& v,
                                              float& a, float scale,
                                              float bc1, float bc2,
                                              float neg_lr, const Hyper& h) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2),
                __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  u = __fadd_rn(u, __fmul_rn(h.weight_decay, a));
  a = __fadd_rn(a, __fmul_rn(u, neg_lr));
}

// The update of one leaf. With MASTER the float32 master copy is the
// anchor a, and p receives a rounded to TP; without it p (float32) is.
template <typename TP, typename TG, bool MASTER, int N>
__global__ void __launch_bounds__(kThreads)
    update_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                  float* __restrict__ mu, float* __restrict__ nu,
                  float* __restrict__ master, const float* __restrict__ scale,
                  const float* __restrict__ bc1_p,
                  const float* __restrict__ bc2_p,
                  const float* __restrict__ lr_p, int n, int head, int nvec,
                  Hyper h) {
  const float s = scale ? *scale : 1.0f;
  const float bc1 = *bc1_p, bc2 = *bc2_p, neg_lr = -*lr_p;
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = t0; i < nvec; i += stride) {
    const int e = head + i * N;
    float gv[N], m[N], v[N], a[N];
    load<N>(g + e, gv);
    load<N>(mu + e, m);
    load<N>(nu + e, v);
    if constexpr (MASTER) load<N>(master + e, a);
    else load<N>(p + e, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      adamw_element(gv[j], m[j], v[j], a[j], s, bc1, bc2, neg_lr, h);
    store<N>(mu + e, m);
    store<N>(nu + e, v);
    if constexpr (MASTER) store<N>(master + e, a);
    store<N>(p + e, a);
  }
  const int rest = n - nvec * N;
  for (int r = t0; r < rest; r += stride) {
    const int e = r < head ? r : r + nvec * N;
    float m = mu[e], v = nu[e];
    float a = MASTER ? master[e] : to_f32(p[e]);
    adamw_element(to_f32(g[e]), m, v, a, s, bc1, bc2, neg_lr, h);
    mu[e] = m;
    nu[e] = v;
    if constexpr (MASTER) master[e] = a;
    from_f32(a, p + e);
  }
}

template <typename TG>
cudaError_t sumsq(const void* g, void* partials, int n, int head, int nvec,
                  int blocks, void* stream) {
  constexpr int N = 16 / sizeof(TG);
  sumsq_kernel<TG, N><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TG*>(g), n, head, nvec,
      static_cast<double*>(partials));
  return cudaGetLastError();
}

template <typename TP, typename TG, bool MASTER>
cudaError_t update(void* p, const void* g, void* mu, void* nu, void* master,
                   const void* scale, const void* bc1, const void* bc2,
                   const void* lr, int n, int head, int nvec, int blocks,
                   float b1, float one_minus_b1, float b2, float one_minus_b2,
                   float eps, float weight_decay, void* stream) {
  // 16 bytes of the narrowest array a thread.
  constexpr int N = (sizeof(TP) == 2 || sizeof(TG) == 2) ? 8 : 4;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  update_kernel<TP, TG, MASTER, N><<<blocks, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(master), static_cast<const float*>(scale),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(lr), n, head, nvec, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int adamw_sumsq_f32(const void* g, void* partials, int n, int head, int nvec,
                    int blocks, void* stream) {
  return static_cast<int>(
      sumsq<float>(g, partials, n, head, nvec, blocks, stream));
}

int adamw_sumsq_bf16(const void* g, void* partials, int n, int head,
                     int nvec, int blocks, void* stream) {
  return static_cast<int>(
      sumsq<__nv_bfloat16>(g, partials, n, head, nvec, blocks, stream));
}

int adamw_sumsq_finish(const void* partials, void* out, int slots,
                       int leaves, void* stream) {
  sumsq_finish_kernel<<<1, kFinishThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), slots, leaves,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

#define ADAMW_UPDATE(NAME, TP, TG, MASTER)                                   \
  int NAME(void* p, const void* g, void* mu, void* nu, void* master,        \
           const void* scale, const void* bc1, const void* bc2,             \
           const void* lr, int n, int head, int nvec, int blocks, float b1, \
           float one_minus_b1, float b2, float one_minus_b2, float eps,     \
           float weight_decay, void* stream) {                              \
    return static_cast<int>(update<TP, TG, MASTER>(                         \
        p, g, mu, nu, master, scale, bc1, bc2, lr, n, head, nvec, blocks,   \
        b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, stream));    \
  }

// adamw_update_p<param type>_g<gradient type>[_master]
ADAMW_UPDATE(adamw_update_pf32_gf32, float, float, false)
ADAMW_UPDATE(adamw_update_pf32_gbf16, float, __nv_bfloat16, false)
ADAMW_UPDATE(adamw_update_pf32_gf32_master, float, float, true)
ADAMW_UPDATE(adamw_update_pf32_gbf16_master, float, __nv_bfloat16, true)
ADAMW_UPDATE(adamw_update_pbf16_gf32_master, __nv_bfloat16, float, true)
ADAMW_UPDATE(adamw_update_pbf16_gbf16_master, __nv_bfloat16, __nv_bfloat16,
             true)

#undef ADAMW_UPDATE

}  // extern "C"
