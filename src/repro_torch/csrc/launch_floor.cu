// An empty kernel: what any launch of a given grid costs the card, with
// no memory traffic and no arithmetic. chip_smoke.py times it between
// the same CUDA events as a real kernel of the same grid, so that a
// kernel's time can be read against the floor a launch sets. It replaces
// no TPU kernel and is on no path of the port.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
