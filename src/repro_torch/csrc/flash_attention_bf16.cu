// Forward attention with online softmax ("flash" attention) for bfloat16
// q, k, v and o, grouped-query heads:
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g])
//                v[b, j, h / g]
// with right-aligned causal masking (query i sees keys j <= i + Skv - Sq)
// or none.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (body _flash_body) for bfloat16 inputs; csrc/flash_attention.cu keeps
// the float32 route. It computes what that kernel computes: running max
// m, running sum l and the accumulator in float32, masked keys with
// probability 0 (the running max never falls below -1e30, so
// exp(m_prev - m_new) is never NaN), o = acc / max(l, 1e-30) rounded to
// bf16. Two things differ by a rounding: q . k is scaled after the
// product, in float32, so q is never rounded after its cast (what
// models/attention.py:q_scale asks for), and P enters P.V as bf16, as in
// FlashAttention-2 and -3.
//
// What bounds it on the H100: operations. Causal self-attention at the
// served shape (qwen2.5-32b, 4 x 1,024 tokens, 40 q heads on 8 kv heads,
// D = 128) is 43.0 GFLOP of useful work against 100.7 MB of q, k, v and
// o: 43.5 us at the dense bf16 rate of 989 TFLOP/s, 30 us of bytes at
// 3.35 TB/s. That rate is wgmma's alone. The float32 route this
// replaces ran bf16 through 2xTF32 products on float32 tiles widened at
// load, with synchronous loads (660 us at that prefill); and the model
// widened k and v to 40 heads and copied all three to heads-first
// layout before it.
//
// Design (FlashAttention-3's shape, without its ping-pong and
// intra-warpgroup overlap):
// - Operands stay bf16 all the way: Q, K and V tiles sit in shared
//   memory as bf16, each tile as D/64 column blocks of rows x 128 bytes
//   in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)),
//   the layout wgmma reads.
// - TMA copies them: one tensor map each for q, k and v over the (B, S,
//   H, D) layout at the strides the caller has (encoded on the host
//   with cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint:
//   no link to libcuda), passed as __grid_constant__ parameters. GQA is
//   the tensor map's head coordinate: q head h reads kv head h / g, and
//   nothing is widened. One producer warp keeps a ring of two K and V
//   stages full: a copy completes on the stage's full mbarrier, and the
//   producer refills a stage once every consumer warp has arrived on its
//   empty mbarrier.
// - Consumer warpgroups of 64 query rows (block_q / 64 of them) run both
//   products as wgmma.mma_async with float32 accumulators: S = Q K^T as
//   m64n{block_k}k16 with Q and K from shared memory (both K-major),
//   then O += P V as m64n{D}k16 with P from registers and V from shared
//   memory, transposed by the instruction (V's rows are keys, its
//   columns the product's N). The score accumulator of two 8-key groups
//   is the register A fragment of a 16-key step of P.V, so P goes to the
//   tensor cores as packed bf16 pairs, with no shuffle and no shared
//   memory.
// - The causal mask is applied only where a tile crosses the diagonal;
//   tiles wholly above it are never loaded, and a warpgroup skips the
//   products of a tile none of its rows sees. The grid walks query
//   blocks heaviest first across all heads (the slow grid index is the
//   query block, from the last), so the longest CTAs start first.
// - A warpgroup waits for its S before its softmax and for its P.V
//   before the next S: the overlap of one with the other comes from the
//   other warpgroups on the SM, not from inside a warpgroup.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowsPerWarp = 16;
constexpr int kMaxThreads = 288;        // 2 consumer warpgroups + 1 warp
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit
constexpr int kStages = 2;              // the K and V rings
constexpr int kAtomCols = 64;           // bf16 columns of a 128-byte row
constexpr int kAlign = 1024;            // the 128-byte swizzle's period
constexpr int kBarBytes = 8 * (1 + 3 * kStages);
// A tile that has not arrived after this many polls of its barrier
// (seconds) traps instead of hanging the card.
constexpr uint32_t kMaxPolls = 1u << 26;

struct Strides {
  long long b, s, h;
};

struct Geometry {
  int heads, group, n_qb, n_bh, Sq, Skv, block_q, causal;
  float scale_log2;                     // scale * log2(e)
  Strides o;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// A shared-memory matrix descriptor of a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units).
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

// Registers an asynchronous product reads or writes stay where they are
// until this point (no instruction of the compiler's moves across it).
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

// d (+)= A B for a 64 x 16 A and a 16 x 64 B, both K-major in shared
// memory (descriptors da, db); d is the 64 x 64 float32 accumulator,
// overwritten unless accumulate.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 16 A and a 16 x 128 B, both K-major in shared
// memory (descriptors da, db); d is the 64 x 128 float32 accumulator,
// overwritten unless accumulate.
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
// fragment of its 16 rows) and a 16 x 64 B in shared memory stored
// N-major (descriptor db; the instruction transposes it).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 16 A in registers (each warp's m16n8k16 A
// fragment of its 16 rows) and a 16 x 128 B in shared memory stored
// N-major (descriptor db; the instruction transposes it).
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

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x with one MUFU op (exp2f also guards results below 2^-126, which
// this kernel may flush to 0: they are probabilities under 1e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BK>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          uint16_t* __restrict__ o, const Geometry geo) {
  constexpr int NS = BK / 2;            // score registers of a thread
  constexpr int NO = D / 2;             // output registers of a thread
  constexpr int KQ = D / 16;            // 16-deep steps of Q K^T
  constexpr int KP = BK / 16;           // 16-key steps of P V
  constexpr int TILE = BK * D * 2;      // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int block_q = geo.block_q, causal = geo.causal;
  const int n_cw = block_q / kRowsPerWarp;  // consumer warps
  // Heavy (late, causal) query blocks first over every head.
  const int qb = geo.n_qb - 1 - static_cast<int>(blockIdx.x) / geo.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % geo.n_bh;
  const int b = bh / geo.heads, h = bh - b * geo.heads;
  const int hk = h / geo.group;
  const int q0 = qb * block_q;
  const int q_offset = geo.Skv - geo.Sq;
  int n_tiles = geo.Skv / BK;
  if (causal) {
    const int last = q0 + block_q - 1 + q_offset;   // largest query position
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  const uint32_t sQ =
      (smem_u32(smem_raw) + (kAlign - 1)) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t sK = sQ + block_q * D * 2;
  const uint32_t sV = sK + kStages * TILE;
  // Barriers: Q; then per stage, K full, V full, and empty (every
  // consumer warp is done with the stage).
  const uint32_t bar_q = sV + kStages * TILE;
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
      bar_expect(bar_q, block_q * D * 2);
      tma_tile<D>(sQ, &tm_q, bar_q, block_q, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) bar_wait(empty + 8 * st, (it / kStages + 1) & 1);
        bar_expect(full_k + 8 * st, TILE);
        tma_tile<D>(sK + st * TILE, &tm_k, full_k + 8 * st, BK, it * BK,
                    hk, b);
        bar_expect(full_v + 8 * st, TILE);
        tma_tile<D>(sV + st * TILE, &tm_v, full_v + 8 * st, BK, it * BK,
                    hk, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the
  // block, its warp w rows 16 w .. 16 w + 15 of those.
  const int wg = warp >> 2;
  const int r0 = 64 * wg + kRowsPerWarp * (warp & 3);
  const int qpos = q0 + r0 + g + q_offset;  // position of row g (g+8: +8)
  const int wg_last = q0 + 64 * wg + 63 + q_offset;
  const uint32_t q_rows = sQ + 64 * wg * 128;
  float acc[NO], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  bar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = it * BK;
    const uint32_t kt = sK + st * TILE, vt = sV + st * TILE;
    // Keys of this tile the warpgroup's last row sees (all if not
    // causal): the same in every thread of the warpgroup.
    const int live = causal ? min(BK, wg_last - k0 + 1) : BK;
    bar_wait(full_k + 8 * st, parity);
    // s[4j + e]: row g (e < 2) or g + 8, key 8j + 2t + (e & 1).
    float s[NS];
    uint32_t pa[KP][4];
    if (live > 0) {
      // S = Q K^T, 16 deep a step: Q's and K's rows are 128-byte lines,
      // 64 columns a block; a step moves 32 bytes along them.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss<BK>(
            s, smem_desc(q_rows + (kk / 4) * block_q * 128 + step, 16, 1024),
            smem_desc(kt + (kk / 4) * BK * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit_and_wait();
      pin(s);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= geo.scale_log2;
      // The causal mask, only where the tile crosses the diagonal.
      if (causal && k0 + BK - 1 > qpos - g) {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) > qpos + 8 * (e >> 1))
              s[4 * j + e] = -CUDART_INF_F;
      }
      // Online softmax: row max over the quad, exp2, partial row sums
      // (each lane sums its own columns; the quad adds them at the end).
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
      // P as the A fragments of P V: key groups 2kk and 2kk + 1 of the
      // scores are the 16-key step kk.
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }

    bar_wait(full_v + 8 * st, parity);
    if (live > 0) {
      // O += P V, 16 keys a step: V's rows are keys, its columns (the
      // product's N) contiguous, so the instruction transposes it; 8-key
      // row groups 1,024 bytes apart, 64-column blocks a tile apart.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        if (16 * kk < live)
          wgmma_rs<D>(acc, pa[kk],
                      smem_desc(vt + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit_and_wait();
      pin(acc);
      pin(pa);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);
  }

  uint16_t* orow = o + b * geo.o.b + h * geo.o.h +
                   (q0 + r0 + g) * geo.o.s + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * r * geo.o.s + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

size_t smem_bytes(int D, int block_q, int block_k) {
  return static_cast<size_t>(block_q + 2 * kStages * block_k) * D * 2 +
         kBarBytes + kAlign;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda); null if the CUDA driver has none.
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

// A 4-D map over (D, S, H, B), innermost first, at the byte strides of
// st, copying boxes of 64 columns x rows rows. A dimension of one is
// never stepped along: its stride (0 from the caller) is set to a row's.
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

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* dims, int block_q, int causal,
                   float scale, void* stream) {
  const long long B = dims[0], Hq = dims[1], Hkv = dims[2], Sq = dims[3],
                  Skv = dims[4];
  const size_t smem = smem_bytes(D, block_q, BK);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long blocks = B * Hq * (Sq / block_q);
  if (blocks == 0) return cudaSuccess;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  const Strides sq{dims[6], dims[7], dims[8]}, sk{dims[9], dims[10], dims[11]},
      sv{dims[12], dims[13], dims[14]};
  if (!tensor_map(&mq, q, D, Sq, Hq, B, sq, block_q) ||
      !tensor_map(&mk, k, D, Skv, Hkv, B, sk, BK) ||
      !tensor_map(&mv, v, D, Skv, Hkv, B, sv, BK))
    return cudaErrorInvalidValue;
  Geometry geo;
  geo.heads = static_cast<int>(Hq);
  geo.group = static_cast<int>(Hq / Hkv);
  geo.n_qb = static_cast<int>(Sq / block_q);
  geo.n_bh = static_cast<int>(B * Hq);
  geo.Sq = static_cast<int>(Sq);
  geo.Skv = static_cast<int>(Skv);
  geo.block_q = block_q;
  geo.causal = causal;
  geo.scale_log2 = scale * kLog2e;
  geo.o = Strides{dims[15], dims[16], dims[17]};
  flash_fwd_bf16_kernel<D, BK><<<static_cast<unsigned>(blocks),
                                 block_q / kRowsPerWarp * 32 + 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q and o (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), bfloat16, at the
// element strides in dims (B, Hq, Hkv, Sq, Skv, D, then (b, s, h) of q,
// k, v, o; 0 for a dimension of one); D contiguous, every stride and
// base 16-byte aligned; D in {64, 128}; block_q 64 or 128, dividing Sq;
// block_k 64 or 128, dividing Skv; Hq a multiple of Hkv, q head h
// reading kv head h / (Hq / Hkv). scale multiplies q . k.
int flash_attention_bf16_bshd(const void* q, const void* k, const void* v,
                              void* o, const long long* dims, int block_q,
                              int block_k, int causal, float scale,
                              void* stream) {
  const long long Hq = dims[1], Hkv = dims[2], Sq = dims[3], Skv = dims[4],
                  D = dims[5];
  if ((block_q != 64 && block_q != 128) || Sq % block_q != 0 ||
      Skv % block_k != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq >= (1LL << 31) || Skv >= (1LL << 31) || dims[0] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && block_k == 64)
    err = launch<64, 64>(q, k, v, o, dims, block_q, causal, scale, stream);
  else if (D == 64 && block_k == 128)
    err = launch<64, 128>(q, k, v, o, dims, block_q, causal, scale, stream);
  else if (D == 128 && block_k == 64)
    err = launch<128, 64>(q, k, v, o, dims, block_q, causal, scale, stream);
  else if (D == 128 && block_k == 128)
    err = launch<128, 128>(q, k, v, o, dims, block_q, causal, scale, stream);
  return static_cast<int>(err);
}

}  // extern "C"
