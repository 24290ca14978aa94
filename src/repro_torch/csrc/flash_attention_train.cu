// Causal self-attention for training: a forward that keeps what the
// backward needs, and FlashAttention-2's backward, for bfloat16 q, k, v
// (B, S, H, D_QK | D_V), one kv head a q head, keys at positions 0..S-1
// all valid, query i seeing keys j <= i:
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
//
// Replaces no TPU kernel. The reference's Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py) has no backward, and the
// reference trains through its XLA streaming softmax
// (src/repro/models/attention.py), which the port's plain route
// (models/attention.py:_streaming) repeats: f32 scores of the bf16
// operands block after block, f32 P.V, remat in the backward. This
// computes the same sums on the tensor cores.
//
// Precision, the same work and not less. q, k, v and dO are bf16 values,
// so their products are exact in the f32 accumulators, as the plain
// route's f32 products of the widened values are. The scale multiplies
// after the product, in f32. P and dS are f32 values: each enters its
// products as hi + lo, hi = bf16(x) and lo = bf16(x - hi), two products
// (about 16 bits of the f32 operand; what is left is below 2^-17 of x).
// The forward writes o in bf16 for the model and in f32 for the
// backward's D = rowsum(dO * o), which the plain route's autograd takes
// from the f32 o; dq, dk and dv are rounded once, from f32 accumulators.
//
// What bounds it on the H100: operations. At Moonlight's latent
// attention (16 heads, D_QK 192, D_V 128) and 8,192 tokens a layer's
// causal pairs are 537 M; the forward's products are 2 (192 + 2 x 128)
// FLOP a pair (P split), the backward's 2 (192 + 128 + 2 x 128 + 2 x 192)
// for dK and dV and 2 (192 + 128 + 2 x 192) for dQ: 2.75 TFLOP a layer
// with the layer checkpoint's second forward, 2.8 ms at the dense bf16
// rate; the bytes (q, k, v, o and its f32 copy, dO, the gradients: 0.4
// GB) 0.12 ms.
//
// Design:
// - Forward: the served kernel's (csrc/flash_attention_bf16.cu): a TMA
//   ring of K and V tiles kept full by a producer warp, two consumer
//   warpgroups of 64 query rows running wgmma with f32 accumulators,
//   tiles above the diagonal never loaded, query blocks heaviest first.
//   Templated on (D_QK, D_V); P.V is two wgmmas a 16-key step (hi, lo).
//   It writes o (bf16), o (f32) and each row's log-sum-exp (f32, B, H,
//   S) for the backward.
// - Backward, two launches, both deterministic (no atomics):
//   * the dQ pass, one CTA of 4 warps a (b, h, 64-query block), heaviest
//     first: D = rowsum(dO * o) of its rows first (written for the next
//     pass), then over the 32-key blocks on and below the diagonal, S =
//     Q K^T, P = exp(scale S - LSE), dP = dO V^T, dS = P (dP - D), dQ +=
//     dS K;
//   * the dK/dV pass, one CTA of 4 warps a (b, h, 64-key block), the
//     longest first: over the 32-query blocks on and below the diagonal,
//     S^T = K Q^T, P^T, dP^T = V dO^T, dS^T, dV += P^T dO, dK += dS^T Q.
//   The dQ pass recomputes S and dP (a third of the backward's products)
//   to keep every sum in one order: two runs give the same bits.
//   Both run mma.sync m16n8k16 (bf16, f32 accumulators) on tiles that
//   cp.async double-buffers in shared memory, rows padded by 16 bytes so
//   that ldmatrix reads them without bank conflicts; ldmatrix.trans gives
//   the transposed operands (dO and Q as B of dV and dK, K as B of dQ).
//   A warp's 16 rows keep their gradient in registers (96 + 64 a thread
//   in the dK/dV pass at D_QK 192); the S and dP tiles of 16 x 32 become
//   the A fragments of the next products in place.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit
// Forward: 128 query rows (two consumer warpgroups) and tiles of 128
// keys, in a ring of two stages; one producer warp.
constexpr int kFwdRows = 128;
constexpr int kFwdKeys = 128;
constexpr int kFwdThreads = kFwdRows / 16 * 32 + 32;
constexpr int kStages = 2;
constexpr int kAtomCols = 64;           // bf16 columns of a 128-byte row
constexpr int kAlign = 1024;            // the 128-byte swizzle's period
constexpr int kBarBytes = 8 * (1 + 3 * kStages);
// Backward: 4 warps of 16 resident rows, streamed blocks of 32 rows.
constexpr int kBwdRows = 64;
constexpr int kBwdStep = 32;
constexpr int kBwdThreads = 128;
constexpr uint32_t kMaxPolls = 1u << 26;

struct Strides {
  long long b, s, h;
};

struct Geometry {
  int heads, n_blocks, n_bh, S;
  float scale, scale_log2;              // scale, scale * log2(e)
  Strides q, k, v, d;                   // d: dO (backward only)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- the forward's TMA ring and wgmma (as csrc/flash_attention_bf16.cu) -----

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kMaxPolls) __trap();
  }
}

// rows x D of (b, head) from row r0 into the tile at dst: one TMA copy
// per 64-column block, completing on bar.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int r0,
                                         int head, int b) {
#pragma unroll
  for (int a = 0; a < D / kAtomCols; ++a)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
            dst + a * rows * 128),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(a * kAtomCols), "r"(r0),
        "r"(head), "r"(b), "r"(bar)
        : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A B for a 64 x 16 A and a 16 x 128 B, both K-major in shared
// memory; d is the 64 x 128 float32 accumulator, overwritten unless
// accumulate.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x 16 A in registers (each warp's m16n8k16 A
// fragment of its 16 rows) and a 16 x 128 B in shared memory stored
// N-major (the instruction transposes it).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// 2^x with one MUFU op (results below 2^-126 flush to 0: probabilities
// under 1e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_train_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           uint16_t* __restrict__ o, float* __restrict__ o32,
                           float* __restrict__ lse, const Geometry geo) {
  static_assert(DV == 128 && kFwdKeys == 128, "n128 products only");
  constexpr int BK = kFwdKeys, BQ = kFwdRows;
  constexpr int NS = BK / 2;            // score registers of a thread
  constexpr int NO = DV / 2;            // output registers of a thread
  constexpr int KQ = DQ / 16;           // 16-deep steps of Q K^T
  constexpr int KP = BK / 16;           // 16-key steps of P V
  constexpr int TK = BK * DQ * 2, TV = BK * DV * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int n_cw = BQ / 16;         // consumer warps
  const int qb = geo.n_blocks - 1 - static_cast<int>(blockIdx.x) / geo.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % geo.n_bh;
  const int b = bh / geo.heads, h = bh - b * geo.heads;
  const int q0 = qb * BQ;
  const int n_tiles = min(geo.S / BK, (q0 + BQ - 1) / BK + 1);

  const uint32_t sQ =
      (smem_u32(smem_raw) + (kAlign - 1)) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t sK = sQ + BQ * DQ * 2;
  const uint32_t sV = sK + kStages * TK;
  const uint32_t bar_q = sV + kStages * TV;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;

  if (tid == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full_k + 8 * s, 1);
      bar_init(full_v + 8 * s, 1);
      bar_init(empty + 8 * s, n_cw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == n_cw) {
    // The producer: one lane keeps the ring full.
    if (lane == 0) {
      bar_expect(bar_q, BQ * DQ * 2);
      tma_tile<DQ>(sQ, &tm_q, bar_q, BQ, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) bar_wait(empty + 8 * st, (it / kStages + 1) & 1);
        bar_expect(full_k + 8 * st, TK);
        tma_tile<DQ>(sK + st * TK, &tm_k, full_k + 8 * st, BK, it * BK, h,
                     b);
        bar_expect(full_v + 8 * st, TV);
        tma_tile<DV>(sV + st * TV, &tm_v, full_v + 8 * st, BK, it * BK, h,
                     b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the
  // block, its warp w rows 16 w .. 16 w + 15 of those.
  const int wg = warp >> 2;
  const int r0 = 64 * wg + 16 * (warp & 3);
  const int qpos = q0 + r0 + g;         // row g (g + 8: qpos + 8)
  const int wg_last = q0 + 64 * wg + 63;
  const uint32_t q_rows = sQ + 64 * wg * 128;
  float acc[NO], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  bar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = it * BK;
    const uint32_t kt = sK + st * TK, vt = sV + st * TV;
    const int live = min(BK, wg_last - k0 + 1);   // keys the warpgroup sees
    bar_wait(full_k + 8 * st, parity);
    // s[4j + e]: row g (e < 2) or g + 8, key 8j + 2t + (e & 1).
    float s[NS];
    uint32_t ph[KP][4], pl[KP][4];
    if (live > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss_n128(
            s, smem_desc(q_rows + (kk / 4) * BQ * 128 + step, 16, 1024),
            smem_desc(kt + (kk / 4) * BK * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit_and_wait();
      pin(s);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= geo.scale_log2;
      if (k0 + BK - 1 > qpos - g) {     // the tile crosses the diagonal
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) > qpos + 8 * (e >> 1))
              s[4 * j + e] = -CUDART_INF_F;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
      // P as the A fragments of P V, hi and lo: key groups 2kk and
      // 2kk + 1 of the scores are the 16-key step kk.
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1], ph[kk][c],
                     pl[kk][c]);
    }

    bar_wait(full_v + 8 * st, parity);
    if (live > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        if (16 * kk < live) {
          const uint64_t dv = smem_desc(vt + kk * 16 * 128, BK * 128, 1024);
          wgmma_rs_n128(acc, ph[kk], dv);
          wgmma_rs_n128(acc, pl[kk], dv);
        }
      wgmma_commit_and_wait();
      pin(acc);
      pin(ph);
      pin(pl);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const long long row =
        (static_cast<long long>(b) * geo.S + qpos + 8 * r) * geo.heads + h;
    uint16_t* orow = o + row * DV + 2 * t;
    float* frow = o32 + row * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const float x = acc[4 * j + 2 * r] * inv,
                  y = acc[4 * j + 2 * r + 1] * inv;
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(x, y);
      *reinterpret_cast<float2*>(frow + 8 * j) = make_float2(x, y);
    }
    if (t == 0)
      lse[static_cast<long long>(bh) * geo.S + qpos + 8 * r] =
          (m[r] + log2f(l[r])) * kLn2;
  }
}

// -- the backward's mma.sync on padded, double-buffered tiles ---------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B, A 16 x 16 (row), B 16 x 8 (col), bf16, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x D bf16 from row r0 of (b, h) at strides st into a tile of rows
// padded to D + 8 elements, 16 bytes a copy, all threads of the CTA.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const uint16_t* __restrict__ src,
                                          Strides st, int b, int h, int r0,
                                          int rows, int tid) {
  constexpr int C = D / 8;              // 16-byte chunks a row
  const uint16_t* base = src + b * st.b + h * st.h;
  for (int i = tid; i < rows * C; i += kBwdThreads) {
    const int r = i / C, c = i - r * C;
    cp_async16(dst + (r * (D + 8) + 8 * c) * 2,
               base + static_cast<long long>(r0 + r) * st.s + 8 * c);
  }
}

// acc (16 rows of the warp x 32 columns) = A B^T with A's 16 rows at a
// (rows of DA padded elements) and B's 32 rows at bt, over DA columns.
template <int DA>
__device__ __forceinline__ void rows_by_rows(float (&acc)[4][4], uint32_t a,
                                             uint32_t bt, int lane) {
  constexpr int P = (DA + 8) * 2;       // bytes of a padded row
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const uint32_t arow = a + (lane & 15) * P + (lane >> 4) * 16;
  const uint32_t brow =
      bt + ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kd = 0; kd < DA / 16; ++kd) {
    uint32_t fa[4];
    ldsm_x4(fa, arow + kd * 32);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, brow + np * 16 * P + kd * 32);
      mma(acc[2 * np], fa, fb[0], fb[1]);
      mma(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// out (16 rows x DO columns) += X B, X the warp's 16 x 32 f32 tile (C
// fragments), entering as hi + lo bf16, and B's 32 rows of DO columns at
// bt (padded rows), read transposed.
template <int DO>
__device__ __forceinline__ void tile_by_rows(float (&out)[DO / 8][4],
                                             const float (&x)[4][4],
                                             uint32_t bt, int lane) {
  constexpr int P = (DO + 8) * 2;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * ks][0], x[2 * ks][1], hi[0], lo[0]);
    split_bf16(x[2 * ks][2], x[2 * ks][3], hi[1], lo[1]);
    split_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3], hi[3], lo[3]);
    const uint32_t brow = bt +
                          (ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                              P +
                          (lane >> 4) * 16;
#pragma unroll
    for (int np = 0; np < DO / 16; ++np) {
      uint32_t fb[4];
      ldsm_x4_t(fb, brow + np * 32);
      mma(out[2 * np], hi, fb[0], fb[1]);
      mma(out[2 * np], lo, fb[0], fb[1]);
      mma(out[2 * np + 1], hi, fb[2], fb[3]);
      mma(out[2 * np + 1], lo, fb[2], fb[3]);
    }
  }
}

// The warp's 16 rows of a gradient, times scale, as bf16 into the
// contiguous (B, S, H, D) dst from row r0.
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* __restrict__ dst,
                                           const float (&acc)[D / 8][4],
                                           float scale, int b, int h,
                                           int r0, const Geometry& geo,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint16_t* row =
        dst +
        ((static_cast<long long>(b) * geo.S + r0 + g + 8 * r) * geo.heads +
         h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kBwdThreads, 2) flash_train_bwd_dq_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ o32, const float* __restrict__ lse,
    float* __restrict__ delta, uint16_t* __restrict__ dq, const Geometry geo) {
  constexpr int PQ = (DQ + 8) * 2, PV = (DV + 8) * 2;   // padded row bytes
  constexpr int STAGE = kBwdStep * (PQ + PV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb = geo.n_blocks - 1 - static_cast<int>(blockIdx.x) / geo.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % geo.n_bh;
  const int b = bh / geo.heads, h = bh - b * geo.heads;
  const int q0 = qb * kBwdRows;
  const int n_kv = (q0 + kBwdRows) / kBwdStep;
  const uint32_t sQ = smem_u32(smem_raw), sO = sQ + kBwdRows * PQ;
  const uint32_t sKV = sO + kBwdRows * PV;          // stages: K then V
  float* sDelta = reinterpret_cast<float*>(smem_raw + kBwdRows * (PQ + PV) +
                                           2 * STAGE);

  load_rows<DQ>(sQ, q, geo.q, b, h, q0, kBwdRows, tid);
  load_rows<DV>(sO, dout, geo.d, b, h, q0, kBwdRows, tid);
  cp_async_commit();
  load_rows<DQ>(sKV, k, geo.k, b, h, 0, kBwdStep, tid);
  load_rows<DV>(sKV + kBwdStep * PQ, v, geo.v, b, h, 0, kBwdStep, tid);
  cp_async_commit();
  const int row0 = q0 + 16 * w + g;     // the thread's rows: row0, row0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = lse[static_cast<long long>(bh) * geo.S + row0 + 8 * r] * kLog2e;
  cp_async_wait<1>();
  __syncthreads();

  {
    // D of the warp's rows: two lanes a row, DV / 2 columns each.
    const int r = 16 * w + (lane >> 1), half = lane & 1;
    const float* orow =
        o32 + ((static_cast<long long>(b) * geo.S + q0 + r) * geo.heads + h) *
                  DV + half * (DV / 2);
    const __nv_bfloat16* drow = reinterpret_cast<const __nv_bfloat16*>(
        smem_raw + kBwdRows * PQ + r * PV) + half * (DV / 2);
    float sum = 0.0f;
#pragma unroll 8
    for (int e = 0; e < DV / 2; e += 2) {
      const float2 ov = *reinterpret_cast<const float2*>(orow + e);
      sum += __bfloat162float(drow[e]) * ov.x +
             __bfloat162float(drow[e + 1]) * ov.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[r] = sum;
      delta[static_cast<long long>(bh) * geo.S + q0 + r] = sum;
    }
    __syncwarp();
    dl[0] = sDelta[16 * w + g];
    dl[1] = sDelta[16 * w + g + 8];
  }

  float acc[DQ / 8][4];
#pragma unroll
  for (int n = 0; n < DQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int last_row = q0 + 16 * w + 15;

  for (int j = 0; j < n_kv; ++j) {
    const uint32_t sK = sKV + (j & 1) * STAGE, sV = sK + kBwdStep * PQ;
    if (j + 1 < n_kv) {
      const uint32_t nk = sKV + ((j + 1) & 1) * STAGE;
      load_rows<DQ>(nk, k, geo.k, b, h, (j + 1) * kBwdStep, kBwdStep, tid);
      load_rows<DV>(nk + kBwdStep * PQ, v, geo.v, b, h, (j + 1) * kBwdStep,
                    kBwdStep, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kBwdStep;
    if (k0 <= last_row) {               // the warp sees a key of the block
      float s[4][4], dp[4][4];
      rows_by_rows<DQ>(s, sQ + 16 * w * PQ, sK, lane);
      rows_by_rows<DV>(dp, sO + 16 * w * PV, sV, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p =
              k0 + 8 * n + 2 * t + (e & 1) > row0 + 8 * r
                  ? 0.0f
                  : fast_exp2(s[n][e] * geo.scale_log2 - lse2[r]);
          s[n][e] = p * (dp[n][e] - dl[r]);          // dS
        }
      tile_by_rows<DQ>(acc, s, sK, lane);
    }
    __syncthreads();
  }
  store_rows<DQ>(dq, acc, geo.scale, b, h, q0 + 16 * w, geo, lane);
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kBwdThreads, 2) flash_train_bwd_dkdv_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, const Geometry geo) {
  constexpr int PQ = (DQ + 8) * 2, PV = (DV + 8) * 2;
  constexpr int STAGE = kBwdStep * (PQ + PV) + 2 * kBwdStep * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kb = static_cast<int>(blockIdx.x) / geo.n_bh;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % geo.n_bh;
  const int b = bh / geo.heads, h = bh - b * geo.heads;
  const int k0 = kb * kBwdRows;
  const int j0 = k0 / kBwdStep, n_q = geo.S / kBwdStep;
  const uint32_t sK = smem_u32(smem_raw), sV = sK + kBwdRows * PQ;
  const uint32_t sQO = sV + kBwdRows * PV;  // stages: Q, dO, LSE, D
  const float* row_lse = lse + static_cast<long long>(bh) * geo.S;
  const float* row_delta = delta + static_cast<long long>(bh) * geo.S;

  // A stage: 32 query rows of Q and dO, and their LSE and D (8 copies of
  // 16 bytes each).
  auto load_stage = [&](int j) {
    const uint32_t st = sQO + ((j - j0) & 1) * STAGE;
    load_rows<DQ>(st, q, geo.q, b, h, j * kBwdStep, kBwdStep, tid);
    load_rows<DV>(st + kBwdStep * PQ, dout, geo.d, b, h, j * kBwdStep,
                  kBwdStep, tid);
    if (tid < 16) {
      const float* src = (tid < 8 ? row_lse : row_delta) + j * kBwdStep +
                         4 * (tid & 7);
      cp_async16(st + kBwdStep * (PQ + PV) + (tid >> 3) * kBwdStep * 4 +
                     16 * (tid & 7),
                 src);
    }
  };
  load_rows<DQ>(sK, k, geo.k, b, h, k0, kBwdRows, tid);
  load_rows<DV>(sV, v, geo.v, b, h, k0, kBwdRows, tid);
  load_stage(j0);
  cp_async_commit();

  float gk[DQ / 8][4], gv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[n][e] = 0.0f;
  const int key0 = k0 + 16 * w + g;     // the thread's keys: key0, key0 + 8

  for (int j = j0; j < n_q; ++j) {
    const uint32_t sQ = sQO + ((j - j0) & 1) * STAGE, sO = sQ + kBwdStep * PQ;
    if (j + 1 < n_q) {
      load_stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qb0 = j * kBwdStep;
    if (k0 + 16 * w <= qb0 + kBwdStep - 1) {   // a query sees a key
      const float* sl = reinterpret_cast<const float*>(
          smem_raw + (sQ - smem_u32(smem_raw)) + kBwdStep * (PQ + PV));
      const float* sd = sl + kBwdStep;
      float s[4][4], dp[4][4];
      rows_by_rows<DQ>(s, sK + 16 * w * PQ, sQ, lane);     // S^T
      rows_by_rows<DV>(dp, sV + 16 * w * PV, sO, lane);    // dP^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);           // query qb0 + c
          const float p = key0 + 8 * (e >> 1) > qb0 + c
                              ? 0.0f
                              : fast_exp2(s[n][e] * geo.scale_log2 -
                                          sl[c] * kLog2e);
          dp[n][e] = p * (dp[n][e] - sd[c]);               // dS^T
          s[n][e] = p;                                     // P^T
        }
      tile_by_rows<DV>(gv, s, sO, lane);
      tile_by_rows<DQ>(gk, dp, sQ, lane);
    }
    __syncthreads();
  }
  store_rows<DQ>(dk, gk, geo.scale, b, h, k0 + 16 * w, geo, lane);
  store_rows<DV>(dv, gv, 1.0f, b, h, k0 + 16 * w, geo, lane);
}

size_t fwd_smem(int DQ, int DV) {
  return static_cast<size_t>(kFwdRows * DQ + kStages * kFwdKeys * (DQ + DV)) *
             2 +
         kBarBytes + kAlign;
}

size_t dq_smem(int DQ, int DV) {
  return static_cast<size_t>(kBwdRows + 2 * kBwdStep) * ((DQ + 8) + (DV + 8)) *
             2 +
         kBwdRows * 4;
}

size_t dkdv_smem(int DQ, int DV) {
  return static_cast<size_t>(kBwdRows + 2 * kBwdStep) * ((DQ + 8) + (DV + 8)) *
             2 +
         2 * (2 * kBwdStep * 4);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, S, H, B), innermost first, at the element strides
// of st (0 for a dimension of one), boxes of 64 columns x rows rows.
bool tensor_map(CUtensorMap* map, const void* base, long long D,
                long long S, long long H, long long B, Strides st,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long row = D * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(st.s ? 2 * st.s : row),
      static_cast<cuuint64_t>(st.h ? 2 * st.h : row),
      static_cast<cuuint64_t>(st.b ? 2 * st.b : row)};
  const cuuint32_t box[4] = {kAtomCols, static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dims: B, S, H, D_QK, D_V, then the (b, s, h) element strides of q, k,
// v and dO (12 values; dO's ignored by the forward).
bool geometry(const long long* dims, int rows, float scale, Geometry* geo) {
  const long long B = dims[0], S = dims[1], H = dims[2];
  if (B <= 0 || H <= 0 || S <= 0 || S % kFwdRows != 0 || S >= (1LL << 30) ||
      B * H * (S / rows) >= (1LL << 31))
    return false;
  geo->heads = static_cast<int>(H);
  geo->n_blocks = static_cast<int>(S / rows);
  geo->n_bh = static_cast<int>(B * H);
  geo->S = static_cast<int>(S);
  geo->scale = scale;
  geo->scale_log2 = scale * kLog2e;
  geo->q = Strides{dims[5], dims[6], dims[7]};
  geo->k = Strides{dims[8], dims[9], dims[10]};
  geo->v = Strides{dims[11], dims[12], dims[13]};
  geo->d = Strides{dims[14], dims[15], dims[16]};
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DQ, int DV>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* o32, void* lse, const long long* dims, float scale,
                void* stream) {
  Geometry geo;
  if (!geometry(dims, kFwdRows, scale, &geo)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(DQ, DV);
  cudaError_t err = allow_smem(flash_train_fwd_kernel<DQ, DV>, smem);
  if (err != cudaSuccess) return err;
  const long long B = dims[0], S = dims[1], H = dims[2];
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, DQ, S, H, B, geo.q, kFwdRows) ||
      !tensor_map(&mk, k, DQ, S, H, B, geo.k, kFwdKeys) ||
      !tensor_map(&mv, v, DV, S, H, B, geo.v, kFwdKeys))
    return cudaErrorInvalidValue;
  flash_train_fwd_kernel<DQ, DV>
      <<<geo.n_blocks * geo.n_bh, kFwdThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          mq, mk, mv, static_cast<uint16_t*>(o), static_cast<float*>(o32),
          static_cast<float*>(lse), geo);
  return cudaGetLastError();
}

template <int DQ, int DV>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* o32, const void* lse,
                   void* delta, void* dq, const long long* dims, float scale,
                   void* stream) {
  Geometry geo;
  if (!geometry(dims, kBwdRows, scale, &geo)) return cudaErrorInvalidValue;
  const size_t smem = dq_smem(DQ, DV);
  cudaError_t err = allow_smem(flash_train_bwd_dq_kernel<DQ, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_train_bwd_dq_kernel<DQ, DV>
      <<<geo.n_blocks * geo.n_bh, kBwdThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
          static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
          static_cast<const float*>(o32), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<uint16_t*>(dq), geo);
  return cudaGetLastError();
}

template <int DQ, int DV>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, const long long* dims, float scale,
                     void* stream) {
  Geometry geo;
  if (!geometry(dims, kBwdRows, scale, &geo)) return cudaErrorInvalidValue;
  const size_t smem = dkdv_smem(DQ, DV);
  cudaError_t err = allow_smem(flash_train_bwd_dkdv_kernel<DQ, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_train_bwd_dkdv_kernel<DQ, DV>
      <<<geo.n_blocks * geo.n_bh, kBwdThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
          static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The three launches take dims = (B, S, H, D_QK, D_V, then the (b, s, h)
// element strides of q, k, v and dO); q and k (B, S, H, D_QK), v and dO
// (B, S, H, D_V), bfloat16, D contiguous, every stride and base 16-byte
// aligned; S a multiple of 128; (D_QK, D_V) (128, 128) or (192, 128).
// Outputs are contiguous: o, dq, dk, dv (B, S, H, D) bfloat16, o32 (B, S,
// H, D_V) float32, lse and delta (B, H, S) float32. scale multiplies
// q . k.

int flash_train_fwd(const void* q, const void* k, const void* v, void* o,
                    void* o32, void* lse, const long long* dims, float scale,
                    void* stream) {
  const long long DQ = dims[3], DV = dims[4];
  cudaError_t err = cudaErrorInvalidValue;
  if (DQ == 128 && DV == 128)
    err = fwd<128, 128>(q, k, v, o, o32, lse, dims, scale, stream);
  else if (DQ == 192 && DV == 128)
    err = fwd<192, 128>(q, k, v, o, o32, lse, dims, scale, stream);
  return static_cast<int>(err);
}

int flash_train_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* o32, const void* lse,
                       void* delta, void* dq, const long long* dims,
                       float scale, void* stream) {
  const long long DQ = dims[3], DV = dims[4];
  cudaError_t err = cudaErrorInvalidValue;
  if (DQ == 128 && DV == 128)
    err = bwd_dq<128, 128>(q, k, v, dout, o32, lse, delta, dq, dims, scale,
                           stream);
  else if (DQ == 192 && DV == 128)
    err = bwd_dq<192, 128>(q, k, v, dout, o32, lse, delta, dq, dims, scale,
                           stream);
  return static_cast<int>(err);
}

int flash_train_bwd_dkdv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, const long long* dims,
                         float scale, void* stream) {
  const long long DQ = dims[3], DV = dims[4];
  cudaError_t err = cudaErrorInvalidValue;
  if (DQ == 128 && DV == 128)
    err = bwd_dkdv<128, 128>(q, k, v, dout, lse, delta, dk, dv, dims, scale,
                             stream);
  else if (DQ == 192 && DV == 128)
    err = bwd_dkdv<192, 128>(q, k, v, dout, lse, delta, dk, dv, dims, scale,
                             stream);
  return static_cast<int>(err);
}

}  // extern "C"
