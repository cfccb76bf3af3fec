// An empty kernel: what one launch of one block costs on its own, with
// nothing to load, compute or store. chip_smoke.py times it with the same
// clock as the hand-written kernels, so a kernel's time at a small shape
// can be read against this floor, which no kernel design removes.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" {

// Launches one block of 32 threads on `stream`, returns cudaGetLastError().
int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
