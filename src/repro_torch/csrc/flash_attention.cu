// Forward attention with online softmax ("flash" attention):
//   o[bh, i] = sum_j softmax_j(scale * q[bh, i] . k[bh, j]) v[bh, j]
// with right-aligned causal masking (query i sees keys j <= i + Skv - Sq).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (body _flash_body). It computes what that kernel computes: running max
// m, running sum l and the accumulator in float32, masked scores set to
// -1e30 (not -inf, so exp(m_prev - m_new) is never NaN) and their
// probabilities to 0, and o = acc / max(l, 1e-30) in q's dtype. The TPU
// grid walked every KV block of a (bh, q-block) in order and carried
// (m, l, acc) in VMEM scratch between grid steps; here one CTA owns a
// (bh, q-block) and walks its KV tiles in a loop. KV tiles that lie
// wholly above the causal diagonal are skipped (the TPU kernel visited
// and masked them); the output is the same.
//
// What bounds it on the H100: operations. Causal self-attention at
// S = 4096, D = 128 does 4*B*H*S^2*D/2 useful flops against 4 tensors of
// B*H*S*D words, hundreds of flops per byte. This simple kernel runs on
// the float32 CUDA cores (67 TFLOP/s), not the tensor cores; wgmma/TMA
// are later work.
//
// Design. One CTA per (bh, block_q query rows), block_q / 8 warps, each
// warp owning 8 query rows. Shared memory holds the CTA's Q tile (scaled,
// float32), one K tile and one V tile of block_k rows (float32), and a
// 32-wide probability row per query row:
//   (block_q*D + block_k*(D+1) + block_k*D + block_q*32) * 4 bytes,
// 213.5 KB at block_q = block_k = 128, D = 128 (under the 227 KB a CTA
// can opt into). Keys are taken 32 (or 16) at a time: lane j scores key
// j against the warp's 8 rows (Q read as float4 broadcasts, K rows padded
// to D+1 words so the 32 lanes hit 32 banks), the warp reduces max and
// sum with shuffles, then every lane accumulates its D/32 output columns
// of the 8 rows from the probabilities (float4 broadcasts) and V (one
// word per lane, conflict-free). acc stays in registers: 8 rows x D/32
// floats per lane. Blocks are runtime arguments (no template per block
// pair); the head dim is a template (64 or 128, ops.py pads to it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowsPerWarp = 8;
constexpr int kMaxThreads = 512;        // block_q <= 128
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit

__device__ __forceinline__ float to_f(float x) { return x; }

__device__ __forceinline__ float to_f(uint16_t x) {
  // bfloat16 is the top half of a float32.
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int n_qb,
                     int Sq, int Skv, int block_q, int block_k, int causal,
                     float scale) {
  constexpr int DPL = D / 32;           // output columns per lane
  constexpr int R = kRowsPerWarp;
  extern __shared__ float smem[];
  float* Qs = smem;                     // block_q x D, pre-scaled
  float* Ks = Qs + block_q * D;         // block_k x (D + 1)
  float* Vs = Ks + block_k * (D + 1);   // block_k x D
  float* Ps = Vs + block_k * D;         // block_q x 32 probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const int bh = blockIdx.x / n_qb;
  // Heavy (late, causal) query blocks first: a shorter tail.
  const int qb = n_qb - 1 - blockIdx.x % n_qb;
  const int q0 = qb * block_q;
  const int q_offset = Skv - Sq;
  const size_t qoff = (static_cast<size_t>(bh) * Sq + q0) * D;
  const size_t koff = static_cast<size_t>(bh) * Skv * D;

  for (int i = tid; i < block_q * D; i += nthr)
    Qs[i] = to_f(q[qoff + i]) * scale;

  const int wrow = warp * R;            // the warp's first row in the tile
  float acc[R][DPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  int n_tiles = Skv / block_k;
  if (causal) {
    const int last = q0 + block_q - 1 + q_offset;   // largest query position
    n_tiles = last < 0 ? 0 : min(n_tiles, last / block_k + 1);
  }
  const int CH = (block_k % 32 == 0) ? 32 : 16;     // keys per chunk

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                    // Qs written / last tile consumed
    const int k0 = t * block_k;
    const size_t toff = koff + static_cast<size_t>(k0) * D;
    for (int i = tid; i < block_k * D; i += nthr) {
      const int r = i / D, c = i - r * D;
      Ks[r * (D + 1) + c] = to_f(k[toff + i]);
      Vs[i] = to_f(v[toff + i]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < block_k; c0 += CH) {
      // Scores: lane j holds key k0 + c0 + j for each of the warp's rows
      // (idle lanes of a 16-key chunk score a valid key and are masked).
      const float* kr = Ks + (c0 + (lane < CH ? lane : CH - 1)) * (D + 1);
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float ka = kr[d], kb = kr[d + 1], kc = kr[d + 2],
                    kd = kr[d + 3];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + (wrow + r) * D + d);
          s[r] = fmaf(qv.x, ka, s[r]);
          s[r] = fmaf(qv.y, kb, s[r]);
          s[r] = fmaf(qv.z, kc, s[r]);
          s[r] = fmaf(qv.w, kd, s[r]);
        }
      }
      // Online softmax over the chunk, row by row.
      const int kpos = k0 + c0 + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int qpos = q0 + wrow + r + q_offset;
        const bool live = lane < CH && (!causal || kpos <= qpos);
        const float sr = live ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float p = live ? expf(sr - m_new) : 0.0f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
        Ps[(wrow + r) * 32 + lane] = p;
      }
      __syncwarp();
      // acc += P V over the chunk's keys, 4 at a time.
      for (int jj = 0; jj < CH; jj += 4) {
        float vr[4][DPL];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            vr[a][i] = Vs[(c0 + jj + a) * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(Ps + (wrow + r) * 32 + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            acc[r][i] = fmaf(p4.x, vr[0][i], acc[r][i]);
            acc[r][i] = fmaf(p4.y, vr[1][i], acc[r][i]);
            acc[r][i] = fmaf(p4.z, vr[2][i], acc[r][i]);
            acc[r][i] = fmaf(p4.w, vr[3][i], acc[r][i]);
          }
        }
      }
      __syncwarp();                     // Ps is rewritten by the next chunk
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + qoff + static_cast<size_t>(wrow + r) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store(orow + lane + 32 * i, acc[r][i] / denom);
  }
}

size_t smem_bytes(int D, int block_q, int block_k) {
  return sizeof(float) * (static_cast<size_t>(block_q) * D +
                          static_cast<size_t>(block_k) * (D + 1) +
                          static_cast<size_t>(block_k) * D +
                          static_cast<size_t>(block_q) * 32);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int block_q, int block_k,
                   int causal, float scale, void* stream) {
  if (block_q < kRowsPerWarp || block_q % kRowsPerWarp != 0 ||
      block_q / kRowsPerWarp * 32 > kMaxThreads || block_k < 16 ||
      block_k % 16 != 0 || Sq % block_q != 0 || Skv % block_k != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, block_q, block_k);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_qb = Sq / block_q;
  const long long blocks = static_cast<long long>(BH) * n_qb;
  if (blocks == 0) return cudaSuccess;
  flash_fwd_kernel<T, D><<<static_cast<unsigned>(blocks),
                           block_q / kRowsPerWarp * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_qb, Sq, Skv, block_q,
      block_k, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Skv, int D, int block_q,
                     int block_k, int causal, float scale, void* stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, BH, Sq, Skv, block_q, block_k, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, Sq, Skv, block_q, block_k,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k and v (BH, Skv, D), o (BH, Sq, D); D in {64, 128};
// Sq a multiple of block_q (a multiple of 8, at most 128), Skv of
// block_k (a multiple of 16). scale multiplies q . k.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, int BH, int Sq, int Skv, int D, int block_q,
                        int block_k, int causal, float scale, void* stream) {
  return static_cast<int>(launch_d<float>(q, k, v, o, BH, Sq, Skv, D,
                                          block_q, block_k, causal, scale,
                                          stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int BH, int Sq, int Skv, int D,
                         int block_q, int block_k, int causal, float scale,
                         void* stream) {
  return static_cast<int>(launch_d<uint16_t>(q, k, v, o, BH, Sq, Skv, D,
                                             block_q, block_k, causal, scale,
                                             stream));
}

}  // extern "C"
