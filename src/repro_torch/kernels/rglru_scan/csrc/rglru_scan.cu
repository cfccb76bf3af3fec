// RG-LRU gated linear recurrence (RecurrentGemma / Griffin), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py:55  rglru_scan_pallas
// and computes its function: per (batch, channel),
//   h_t = exp(log_a_t) h_{t-1} + b_t
// from h_0 = h0, returning every h_t and h_last. Held to the PyTorch twin
// in ../ref.py, whose arithmetic it follows (exp, a rounded product, a
// rounded sum; no contraction into an FMA).
//
// Bound: HBM bytes. log_a and b are read and h written once, 12 bytes
// per (b, t, channel), for 3 operations; at S = 1 (decode) the launch
// and one dependent load chain are all there is.
//
// Design (simple and right first): the TPU kernel evaluates a chunk in
// closed form through a (chunk, chunk, block_d) transition tensor, to
// turn the sequential scan into wide vector work. On Hopper the scan
// needs no such tensor: one thread per (batch, channel) walks t, the
// model layout (B, S, W) keeps a warp's loads contiguous in W, and the
// loads of eight steps are issued before their dependent updates so
// that enough bytes are in flight. Every exponent is <= 0, so the
// strongest decay gives 0, never an overflow.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // time steps whose loads are issued together

__device__ __forceinline__ float step(float la, float h, float b) {
  return __fadd_rn(__fmul_rn(expf(la), h), b);
}

// grid ceil(B * W / kThreads), block kThreads; thread = (b, channel).
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ b, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int B,
                      int S, int W) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * W) return;
  const int bi = idx / W;
  const int c = idx % W;
  const size_t base = static_cast<size_t>(bi) * S * W + c;
  float h = h0[idx];
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    float la[kAhead], bb[kAhead];
#pragma unroll
    for (int e = 0; e < kAhead; ++e) {
      const size_t off = base + static_cast<size_t>(t + e) * W;
      la[e] = log_a[off];
      bb[e] = b[off];
    }
#pragma unroll
    for (int e = 0; e < kAhead; ++e) {
      h = step(la[e], h, bb[e]);
      y[base + static_cast<size_t>(t + e) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + static_cast<size_t>(t) * W;
    h = step(log_a[off], h, b[off]);
    y[off] = h;
  }
  h_last[idx] = h;
}

}  // namespace

extern "C" {

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// log_a, b, y (B, S, W); h0, h_last (B, W); all fp32, contiguous; S >= 1.
// Launches on `stream`, returns cudaGetLastError().
int rglru_scan_launch(const float* log_a, const float* b, const float* h0,
                      float* y, float* h_last, int B, int S, int W,
                      void* stream) {
  const int blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      log_a, b, h0, y, h_last, B, S, W);
  return cudaGetLastError();
}

}  // extern "C"
