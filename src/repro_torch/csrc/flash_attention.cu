// Forward attention with online softmax ("flash" attention), float32,
// grouped-query heads:
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g])
//                v[b, j, h / g]
// with right-aligned causal masking (query i sees keys j <= i + Skv - Sq).
// q and o are (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), g = Hq / Hkv, each
// read and written at the element strides the caller gives (D
// contiguous): the model's projections as they lie, no copy, no widening.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (body _flash_body) for float32 inputs; bfloat16 inputs have a kernel of
// their own (csrc/flash_attention_bf16.cu). It computes what that kernel
// computes: running max
// m, running sum l and the accumulator in float32, masked keys with
// probability 0 (the running max never falls below -1e30, so
// exp(m_prev - m_new) is never NaN), and o = acc / max(l, 1e-30) in q's
// dtype. The TPU grid walked every KV block of a (bh, q-block) in order
// and carried (m, l, acc) in VMEM scratch between grid steps; here one
// CTA owns a (bh, q-block) and walks its KV tiles in a loop. KV tiles
// that lie wholly above the causal diagonal are skipped (the TPU kernel
// visited and masked them); the output is the same.
//
// What bounds it on the H100: operations. Causal self-attention at
// S = 4096, D = 128 does 4*B*H*S^2*D/2 useful flops against 4 tensors of
// B*H*S*D words, hundreds of flops per byte. Both products run on the
// tensor cores with the warp-level mma.sync.m16n8k8 in TF32. TF32 keeps
// 11 bits of mantissa, so each operand x is split as big = tf32(x),
// small = tf32(x - big) and a product takes three MMAs (small*big,
// big*small, then big*big; small*small is dropped): "3xTF32", float32
// accuracy at three times the TF32 work (the bound is 3x the flops at
// the dense TF32 rate). A single TF32 pass is ~1e-3 off at D = 128
// (tests/test_torch_attention.py emulates both).
//
// Design. One CTA per (b, q head, block_q query rows), one warp per 16
// rows.
// Shared memory holds the Q tile (scaled by scale * log2(e), so the
// softmax takes exp2), one K tile and one V tile of BK rows, float32,
// rows padded to D+4 words: (block_q + 2 BK) (D + 4) 4 bytes, 202.8 KB
// at 128 x 128, D = 128 (under the 227 KB a CTA can opt into). Every
// fragment load then hits 32 distinct banks: A (rows g, g+8, columns t,
// t+4) and B of K (keys g, dims t, t+4) at bank 4g + t, B of V (keys
// 2t, 2t+1, dims g) at 8t + g (+4).
// A warp computes its 16 x BK tile of scores into registers (BK/2
// floats a thread), masks it only where the tile crosses the causal
// diagonal, updates (m, l) with shuffles inside the quad of 4 lanes that
// share a row, and feeds P to P.V straight from the score accumulator:
// lane (g, t) holds keys 2t and 2t+1 of each 8-key group, and the k
// slots of each P.V step are permuted to match (slot t is key 2t, slot
// t+4 key 2t+1; V's B fragment reads the same keys), so P needs neither
// shuffles nor shared memory. The O accumulator is D/2 floats a thread.
// P.V of a tile goes into a fresh accumulator (one half of D at a time,
// D/4 floats) that is then added to O: the tensor cores' float32 sums
// are not rounded to nearest, and one running sum over all 4096 keys
// tripled the error (9.0e-6 against 3.4e-6 at 1 x 40 x 4096 x 128 on an
// H100).
// Tiles follow FlashAttention-2's order with one buffer each: V(t) is
// fetched (cp.async) while S(t) is computed, K(t+1) while P(t).V(t) is.
// block_k is a template (16, 32, 64, 128: the score tile lives in
// registers), as is the head dim (64 or 128, ops.py pads to it);
// block_q is a runtime argument.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowsPerWarp = 16;
constexpr int kMaxThreads = 256;        // block_q <= 128
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit

// cvt.rna.tf32.f32 (to nearest, ties away from zero) in two integer
// operations: add half a TF32 ulp, clear the 13 bits TF32 drops. Equal
// to cvt.rna for every finite x, the infinities and quiet NaNs; the
// instruction itself also tests for them, which costs a third operation.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (the error left is below 2^-22 |x|).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a b for a 16x8 A, an 8x8 B and a 16x8 float32 D.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a given split (big ab, small as), b as two floats.
// The small products go first so that they are not lost against the
// big one.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// rows x D of global memory (rows ld elements apart) into shared rows
// of D + 4 floats, times mul, with 16-byte loads.
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int ld, int rows, float mul,
                                          int tid, int nthr) {
  constexpr int C = D / 4;
  for (int i = tid; i < rows * C; i += nthr) {
    const int r = i / C, c = i - r * C;
    float4 x = *reinterpret_cast<const float4*>(src + r * ld + 4 * c);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c) = x;
  }
}

// A K or V tile into shared memory with cp.async (16 bytes a copy, L2
// only), to be waited for with cp_async_wait_all.
template <int D>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src,
                                           int ld, int rows, int tid,
                                           int nthr) {
  constexpr int C = D / 4;
  for (int i = tid; i < rows * C; i += nthr) {
    const int r = i / C, c = i - r * C;
    const uint32_t to = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * (D + 4) + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to),
                 "l"(src + r * ld + 4 * c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// This thread's cp.async copies have landed (a __syncthreads after it
// makes every thread's visible).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// 2^x with one MUFU op (exp2f also guards results below 2^-126, which
// this kernel may flush to 0: they are probabilities under 1e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Element strides of a (B, S, H, D) operand; D is contiguous.
struct Strides {
  long long b, s, h;
};

// One launch: B x heads q heads in blocks of block_q rows; q head h
// reads kv head h / group.
struct Geometry {
  int heads, group, n_qb, Sq, Skv, block_q, causal;
  float scale;
  Strides q, k, v, o;
};

template <int D, int BK>
__global__ void __launch_bounds__(kMaxThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const Geometry geo) {
  const int n_qb = geo.n_qb, Sq = geo.Sq, Skv = geo.Skv;
  const int block_q = geo.block_q, causal = geo.causal;
  constexpr int LD = D + 4;             // shared row stride, in floats
  constexpr int NK = BK / 8;            // 8-key groups of a tile
  constexpr int ND = D / 8;             // 8-dim groups of a row
  // Unrolling the S loop over D whole helps up to 64 keys a tile; at 128
  // it costs more than it gives (measured on the H100).
  constexpr int kSUnroll = BK <= 64 ? ND : 2;
  extern __shared__ float smem[];
  float* Qs = smem;                     // block_q x LD
  float* Ks = Qs + block_q * LD;        // BK x LD
  float* Vs = Ks + BK * LD;             // BK x LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / geo.heads, h = bh - b * geo.heads;
  const int hk = h / geo.group;
  // Heavy (late, causal) query blocks first: a shorter tail.
  const int qb = n_qb - 1 - blockIdx.x % n_qb;
  const int q0 = qb * block_q;
  const int q_offset = Skv - Sq;
  const float* qrow = q + b * geo.q.b + h * geo.q.h + q0 * geo.q.s;
  const float* kb = k + b * geo.k.b + hk * geo.k.h;
  const float* vb = v + b * geo.v.b + hk * geo.v.h;
  // Row strides inside a tile (the host checks that a tile's rows are
  // within 2^31 elements of its first).
  const int q_ld = static_cast<int>(geo.q.s), k_ld = static_cast<int>(geo.k.s),
            v_ld = static_cast<int>(geo.v.s);

  int n_tiles = Skv / BK;
  if (causal) {
    const int last = q0 + block_q - 1 + q_offset;   // largest query position
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }
  if (n_tiles > 0) fetch_rows<D>(Ks, kb, k_ld, BK, tid, nthr);
  copy_rows<D>(Qs, qrow, q_ld, block_q, geo.scale * kLog2e, tid, nthr);

  const int r0 = warp * kRowsPerWarp;   // the warp's first row in the tile
  const int qpos = q0 + r0 + g + q_offset;  // position of row g (g+8: +8)
  const int qlast = q0 + r0 + kRowsPerWarp - 1 + q_offset;
  const float* Qw = Qs + (r0 + g) * LD + t;
  float acc[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait_all();
    __syncthreads();                    // K(it) and Q in place; V(it-1) used
    fetch_rows<D>(Vs, vb + k0 * geo.v.s, v_ld, BK, tid, nthr);

    // Keys of this tile that the warp's last row sees (all if not causal).
    const int live = causal ? min(BK, qlast - k0 + 1) : BK;
    float s[NK][4];
    if (live > 0) {
      // S = Q K^T: s[j] holds rows g, g+8 x keys 8j + 2t, 8j + 2t + 1.
#pragma unroll
      for (int j = 0; j < NK; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const float* Kw = Ks + g * LD + t;
#pragma unroll kSUnroll
      for (int kk = 0; kk < ND; ++kk) {
        const float* qa = Qw + 8 * kk;
        uint32_t ab[4], as[4];
        split(qa[0], ab[0], as[0]);
        split(qa[8 * LD], ab[1], as[1]);
        split(qa[4], ab[2], as[2]);
        split(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float* kr = Kw + 8 * j * LD + 8 * kk;
          mma3(s[j], ab, as, kr[0], kr[4]);
        }
      }
      // The causal mask, only where the tile crosses the diagonal.
      if (causal && k0 + BK - 1 > qpos - g) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) > qpos + 8 * (e >> 1))
              s[j][e] = -CUDART_INF_F;
      }
      // Online softmax: row max over the quad, exp2, partial row sums
      // (each lane sums its own columns; the quad adds them at the end).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * r] *= corr;
          acc[j][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fast_exp2(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
    }

    cp_async_wait_all();
    __syncthreads();                    // V(it) in place; K(it) used
    if (it + 1 < n_tiles)
      fetch_rows<D>(Ks, kb + (k0 + BK) * geo.k.s, k_ld, BK, tid, nthr);

    if (live > 0) {
      // O += P V, 8 keys a step; slot t is key 2t, slot t + 4 key 2t + 1.
      // Each half of D sums the tile into its own accumulator first.
      const float* Vw = Vs + 2 * t * LD + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[ND / 2][4];
#pragma unroll
        for (int j = 0; j < ND / 2; ++j)
          part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (8 * kk < live) {
            uint32_t ab[4], as[4];
            split(s[kk][0], ab[0], as[0]);
            split(s[kk][2], ab[1], as[1]);
            split(s[kk][1], ab[2], as[2]);
            split(s[kk][3], ab[3], as[3]);
            const float* vr = Vw + 8 * kk * LD + 8 * (ND / 2) * h;
#pragma unroll
            for (int j = 0; j < ND / 2; ++j)
              mma3(part[j], ab, as, vr[8 * j], vr[LD + 8 * j]);
          }
        }
#pragma unroll
        for (int j = 0; j < ND / 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[(ND / 2) * h + j][e] += part[j][e];
      }
    }
  }

  float* orow = o + b * geo.o.b + h * geo.o.h + (q0 + r0 + g) * geo.o.s + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(orow + 8 * r * geo.o.s + 8 * j, acc[j][2 * r] * inv,
             acc[j][2 * r + 1] * inv);
  }
}

size_t smem_bytes(int D, int block_q, int block_k) {
  return sizeof(float) * static_cast<size_t>(block_q + 2 * block_k) *
         (D + 4);
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, const Geometry& geo, void* stream) {
  const size_t smem = smem_bytes(D, geo.block_q, BK);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long blocks =
      static_cast<long long>(batch) * geo.heads * geo.n_qb;
  if (blocks == 0) return cudaSuccess;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  flash_fwd_kernel<D, BK><<<static_cast<unsigned>(blocks),
                            geo.block_q / kRowsPerWarp * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), geo);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bk(const void* q, const void* k, const void* v, void* o,
                      int batch, const Geometry& geo, int block_k,
                      void* stream) {
  switch (block_k) {
    case 16:
      return launch<D, 16>(q, k, v, o, batch, geo, stream);
    case 32:
      return launch<D, 32>(q, k, v, o, batch, geo, stream);
    case 64:
      return launch<D, 64>(q, k, v, o, batch, geo, stream);
    case 128:
      return launch<D, 128>(q, k, v, o, batch, geo, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dims: B, Hq, Hkv, Sq, Skv, D, then the (b, s, h) element strides of
// q, k, v and o.
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const long long* dims, int block_q, int block_k,
                     int causal, float scale, void* stream) {
  const long long B = dims[0], Hq = dims[1], Hkv = dims[2], Sq = dims[3],
                  Skv = dims[4], D = dims[5];
  if (block_q < kRowsPerWarp || block_q % kRowsPerWarp != 0 ||
      block_q / kRowsPerWarp * 32 > kMaxThreads || Sq % block_q != 0 ||
      block_k <= 0 || Skv % block_k != 0 || B < 0 || Hq <= 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || Sq >= (1LL << 31) ||
      Skv >= (1LL << 31) || Hq >= (1LL << 31))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)                // q, k, v rows inside a tile
    if (dims[7 + 3 * i] < 0 || dims[7 + 3 * i] * kMaxThreads >= (1LL << 31))
      return cudaErrorInvalidValue;
  Geometry geo;
  geo.heads = static_cast<int>(Hq);
  geo.group = static_cast<int>(Hq / Hkv);
  geo.n_qb = static_cast<int>(Sq / block_q);
  geo.Sq = static_cast<int>(Sq);
  geo.Skv = static_cast<int>(Skv);
  geo.block_q = block_q;
  geo.causal = causal;
  geo.scale = scale;
  Strides* st[4] = {&geo.q, &geo.k, &geo.v, &geo.o};
  for (int i = 0; i < 4; ++i)
    *st[i] = Strides{dims[6 + 3 * i], dims[7 + 3 * i], dims[8 + 3 * i]};
  const int batch = static_cast<int>(B);
  switch (D) {
    case 64:
      return launch_bk<64>(q, k, v, o, batch, geo, block_k, stream);
    case 128:
      return launch_bk<128>(q, k, v, o, batch, geo, block_k, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The (BH, S, D) layout: B = BH, one head, rows D apart.
void flat_dims(long long* dims, int BH, int Sq, int Skv, int D) {
  const long long d[18] = {BH, 1, 1, Sq, Skv, D,
                           1LL * Sq * D, D, 0, 1LL * Skv * D, D, 0,
                           1LL * Skv * D, D, 0, 1LL * Sq * D, D, 0};
  for (int i = 0; i < 18; ++i) dims[i] = d[i];
}

}  // namespace

extern "C" {

// q and o (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) at the element
// strides in dims (B, Hq, Hkv, Sq, Skv, D, then (b, s, h) of q, k, v,
// o); D contiguous, rows 16-byte aligned; D in {64, 128}; Sq a multiple
// of block_q (a multiple of 16, at most 128), Skv of block_k (16, 32, 64
// or 128); Hq a multiple of Hkv, q head h reading kv head
// h / (Hq / Hkv). scale multiplies q . k.
int flash_attention_f32_bshd(const void* q, const void* k, const void* v,
                             void* o, const long long* dims, int block_q,
                             int block_k, int causal, float scale,
                             void* stream) {
  return static_cast<int>(
      launch_d(q, k, v, o, dims, block_q, block_k, causal, scale, stream));
}

// q (BH, Sq, D), k and v (BH, Skv, D), o (BH, Sq, D), contiguous: the
// case B = BH, one head, of flash_attention_f32_bshd.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, int BH, int Sq, int Skv, int D, int block_q,
                        int block_k, int causal, float scale, void* stream) {
  long long dims[18];
  flat_dims(dims, BH, Sq, Skv, D);
  return flash_attention_f32_bshd(q, k, v, o, dims, block_q, block_k, causal,
                                  scale, stream);
}

}  // extern "C"
