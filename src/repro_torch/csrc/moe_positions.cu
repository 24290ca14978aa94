// Slot positions of the mixture-of-experts dispatch: within each group b,
// pos[b, i] is the number of earlier entries j < i of the group's
// flattened (S * k) choices, token-major, that went to the same expert
// (e[b, j] == e[b, i]), and keep[b, i] = pos[b, i] < capacity.
//
// Replaces: no Pallas kernel. The JAX package takes a jnp.cumsum over a
// one-hot (src/repro/models/moe.py:_positions) that XLA fuses. The
// port's plain version (models/moe.py:_positions_plain) builds a bool
// one-hot laid out (B, E, S k), scans it in int32 along its innermost
// dim and gathers each choice's own count: passes over E x S k entries,
// 71.8 / 111.2 / 70.2 us at 1 x 4,096 x 6, 1 x 8,192 x 6 and
// 4 x 1,024 x 6 with E = 64 on the H100. The plain version this kernel
// first replaced scanned an int64 one-hot (B, S k, E) along its outer
// dim, which at B = 1 spreads over only E = 64 columns, each walking
// S k entries one after another (about 13 ms at 1 x 8,192 x 6).
//
// What bounds it on the H100: the launch. Each entry is read once (8 B)
// and written once (8 B of pos, 1 B of keep): 17 B, 0.25 us at 49,152
// entries and 3.35 TB/s, against about 5 us for an empty kernel.
//
// Design: a group is cut into tiles of kItems x blockDim entries, one
// block a tile, all in one launch: no one-hot, nothing in device memory
// but pos and keep, no atomics outside shared memory (the answer is exact
// and the same every run), no host synchronisation (a CUDA graph can
// capture the launch). A block first issues the loads of its own tile,
// then counts each expert's entries in the tiles before its own (a
// shared-memory histogram, 8 loads in flight a thread): the count each
// expert carries into the tile. That rereads the group's earlier entries
// from L2 (a train-8k group's last of 6 blocks reads 40,960, 328 KB) in
// place of a second pass or a look-back between blocks, which would need
// scratch in device memory reset for every call. Warp w holds the tile's
// w-th run of 32 x kItems consecutive entries, item j of lane l at
// 32 j + l, so every load and store is coalesced across the warp. For
// each item in turn, the lanes that chose the same expert are found with
// one ballot per bit of the expert's index (and one for a valid index;
// __match_any_sync measured slower): a lane's rank among them, plus the
// warp's count so far of that expert (one row of E counts a warp, in
// shared memory), is its position within the warp's run. One thread an
// expert then scans the warps' rows into each warp's offset, from the
// carried count. The wrapper sizes the block from the group's length (32
// to 1,024 threads): a decode step's groups of k entries take one warp
// each, a prefill's four groups of 6,144 entries a block of 768 threads
// each, a train step's one group of 49,152 entries 6 blocks of 1,024.
//
// An expert outside [0, E) takes no slot and counts for no one: pos -1,
// keep false. (The plain version raises there; a kernel cannot without a
// synchronisation, and must not index shared memory with it.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 8;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmemBytes = 48 * 1024;

// The lanes whose expert equals this lane's (-1: no expert), from one
// ballot a bit of the index below 2**bits.
__device__ __forceinline__ unsigned same_expert(int ex, int bits) {
  const unsigned valid = __ballot_sync(kFull, ex >= 0);
  unsigned peers = ex >= 0 ? valid : ~valid;
  for (int b = 0; b < bits; ++b) {
    const bool on = (ex >> b) & 1;
    const unsigned lanes = __ballot_sync(kFull, on);
    peers &= on ? lanes : ~lanes;
  }
  return peers;
}

__device__ __forceinline__ int expert_of(int64_t v, int n_experts) {
  return (v >= 0 && v < n_experts) ? static_cast<int>(v) : -1;
}

__global__ void __launch_bounds__(1024)
    moe_positions_kernel(const int64_t* __restrict__ experts,
                         int64_t* __restrict__ pos, bool* __restrict__ keep,
                         int n, int n_experts, int bits, int capacity,
                         int tiles) {
  extern __shared__ int smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  int* carried = smem;                  // [E]: counts of the earlier tiles
  int* counts = smem + n_experts;       // [warps][E]: this tile's, then offsets
  int* mine = counts + warp * n_experts;
  const int64_t group = static_cast<int64_t>(blockIdx.x / tiles) * n;
  const int64_t* in = experts + group;
  const int tile = blockDim.x * kItems;
  const int t0 = (blockIdx.x % tiles) * tile;
  const int first = t0 + warp * kWarp * kItems + lane;

  int64_t v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * kWarp;
    v[j] = i < n ? in[i] : -1;
  }
  for (int t = threadIdx.x; t < (warps + 1) * n_experts; t += blockDim.x)
    smem[t] = 0;
  __syncthreads();
  // The earlier tiles' counts (t0 is a whole number of tiles).
  for (int base = threadIdx.x; base < t0; base += tile) {
    int64_t x[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = in[base + j * blockDim.x];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = expert_of(x[j], n_experts);
      if (e >= 0) atomicAdd(carried + e, 1);
    }
  }
  // Each entry's rank within the warp's run, and the warp's counts.
  int ex[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    ex[j] = expert_of(v[j], n_experts);
    const unsigned peers = same_expert(ex[j], bits);
    const int before = ex[j] >= 0 ? mine[ex[j]] : 0;
    __syncwarp();
    if (ex[j] >= 0 && (peers & below) == 0)
      mine[ex[j]] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & below);
  }
  __syncthreads();
  // Each warp's offset of each expert: the earlier tiles' count plus the
  // earlier warps' of this tile.
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x) {
    int run = carried[e];
    for (int w = 0; w < warps; ++w) {
      const int c = counts[w * n_experts + e];
      counts[w * n_experts + e] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * kWarp;
    if (i < n) {
      const int p = ex[j] >= 0 ? mine[ex[j]] + rank[j] : -1;
      pos[group + i] = p;
      keep[group + i] = ex[j] >= 0 && p < capacity;
    }
  }
}

}  // namespace

extern "C" {

// experts, pos: int64 (groups, n); keep: bool (groups, n); threads a
// multiple of 32 in 32..1024; one block a tile of threads x kItems
// entries of a group, groups x tiles blocks; dynamic shared memory
// (threads / 32 + 1) x n_experts x 4 bytes, opted into above 48 KB.
int moe_positions(const void* experts, void* pos, void* keep, int groups,
                  int n, int n_experts, int capacity, int threads,
                  void* stream) {
  const int smem = (threads / kWarp + 1) * n_experts * 4;
  const int tiles = (n + threads * kItems - 1) / (threads * kItems);
  const int bits = n_experts > 1 ? 32 - __builtin_clz(n_experts - 1) : 0;
  if (smem > kStaticSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_positions_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_positions_kernel<<<groups * tiles, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(experts), static_cast<int64_t*>(pos),
      static_cast<bool*>(keep), n, n_experts, bits, capacity, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
