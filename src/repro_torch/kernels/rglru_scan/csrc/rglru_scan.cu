// RG-LRU gated linear recurrence (RecurrentGemma / Griffin), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py:55  rglru_scan_pallas
// and computes its function: per (batch, channel),
//   h_t = exp(log_a_t) h_{t-1} + b_t
// from h_0 = h0, returning every h_t and h_last. Held to the PyTorch twin
// in ../ref.py, whose arithmetic it follows (exp, a rounded product, a
// rounded sum; no contraction into an FMA), so the two agree bitwise.
//
// Bound: HBM bytes. log_a and b are read and h written once, 12 bytes
// per (b, t, channel), for 3 operations; at S = 1 (decode) the launch
// and one dependent load chain are all there is. Reaching the HBM rate
// takes several MB in flight on the card (3.35 TB/s over a microsecond
// or so of latency) and every SM busy.
//
// Design: the TPU kernel evaluates a chunk in closed form through a
// (chunk, chunk, block_d) transition tensor, to turn the sequential scan
// into wide vector work. On Hopper the scan needs no such tensor: one
// thread per (batch, channel) walks t, as before; what changed is how the
// bytes arrive.
//   * A warp owns 32 channels of one batch row and works alone (no block
//     barrier). For S > 1 a block is one warp, so B 8, W 2560 gives 640
//     blocks, all resident at once and spread over the 132 SMs within one
//     block of each other.
//   * Tiles of kSteps = 32 steps x 32 channels of log_a and b (8 KB) come
//     in through cp.async copies (16-byte runs where W is a multiple of 4
//     and the inputs are 16-byte aligned, else 4-byte copies) into a
//     2-slot ring a warp: the next tile is in flight while one computes,
//     8 KB a warp and 5 MB on the card. (Deeper rings and shorter tiles
//     kept more in flight and ran slower at S 4096 or S 128 on an H100.)
//   * A full tile takes all 32 exp(log_a) first, off the h chain (they do
//     not depend on h), then the chain of rounded products and sums; h
//     replaces b in the tile and leaves as whole coalesced rows (16-byte
//     stores where the copies were 16 bytes).
//   * Decode (S = 1) has nothing to stage: each lane loads its log_a, b
//     and h0 and stores h, in blocks of kShortWarps warps (fewer blocks
//     launch sooner).
//   * A ragged W (the last warp's lanes past W idle) and a ragged S (a
//     short last tile, walked step by step) are handled in the kernel.
//     Every exponent is <= 0, so the strongest decay gives 0, never an
//     overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;         // channels a warp: a lane each
constexpr int kSteps = 32;         // steps a tile
constexpr int kStages = 2;         // tiles in a warp's ring
constexpr int kRuns = kLanes / 4;  // 16-byte runs in a tile row
constexpr int kShortWarps = 4;     // warps a block at S = 1

// A warp's ring: kStages slots of a tile, log_a (kSteps x kLanes) then b,
// which h replaces in place.
constexpr int kSlotFloats = 2 * kSteps * kLanes;
constexpr size_t kRingBytes = sizeof(float) * kStages * kSlotFloats;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float step(float ea, float h, float b) {
  return __fadd_rn(__fmul_rn(ea, h), b);
}

// grid (B * tiles_w), block `warps` x 32 (1 for S > 1, else kShortWarps),
// dynamic shared memory a ring (S > 1); a warp = (batch row, 32 channels),
// on its own: no block barrier.
__global__ void __launch_bounds__(kShortWarps * kLanes)
    rglru_scan_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ b, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int S,
                      int W, int tiles_w, int vec) {
  extern __shared__ __align__(16) float smem[];

  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int bi = blockIdx.x / tiles_w;
  const int c0 = ((blockIdx.x % tiles_w) * warps + warp) * kLanes;
  if (c0 >= W) return;
  const bool live = c0 + lane < W;
  const size_t base = static_cast<size_t>(bi) * S * W + c0;  // (bi, 0, c0)
  const size_t at = static_cast<size_t>(bi) * W + c0 + lane;  // h0, h_last

  if (S == 1) {  // decode: one step, no ring
    if (live) {
      const float h = step(expf(log_a[base + lane]), h0[at], b[base + lane]);
      y[base + lane] = h;
      h_last[at] = h;
    }
    return;
  }

  const int tiles = (S + kSteps - 1) / kSteps;
  float* const ring = smem + warp * kStages * kSlotFloats;
  auto slot = [&](int s) { return ring + (s % kStages) * kSlotFloats; };

  // Tile s into its ring slot; always commits a group (empty past S).
  auto issue = [&](int s) {
    const int t0 = s * kSteps;
    if (t0 < S) {
      const int n = min(kSteps, S - t0);
      float* const la = slot(s);
      float* const bb = la + kSteps * kLanes;
      const float* src_a = log_a + base + static_cast<size_t>(t0) * W;
      const float* src_b = b + base + static_cast<size_t>(t0) * W;
      if (vec) {
#pragma unroll
        for (int e = 0; e < kSteps * kRuns / kLanes; ++e) {
          const int idx = lane + e * kLanes;
          const int row = idx / kRuns;
          const int run = idx % kRuns;
          if (row < n && c0 + 4 * run < W) {
            const size_t off = static_cast<size_t>(row) * W + 4 * run;
            cp_async16(la + row * kLanes + 4 * run, src_a + off);
            cp_async16(bb + row * kLanes + 4 * run, src_b + off);
          }
        }
      } else if (live) {
        for (int row = 0; row < n; ++row) {
          const size_t off = static_cast<size_t>(row) * W + lane;
          cp_async4(la + row * kLanes + lane, src_a + off);
          cp_async4(bb + row * kLanes + lane, src_b + off);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  float h = live ? h0[at] : 0.f;

  for (int s = 0; s < tiles; ++s) {
    issue(s + kStages - 1);  // into the slot tile s - 1 left
    cp_async_wait<kStages - 1>();
    __syncwarp();  // tile s landed for every lane
    const float* const la = slot(s);
    float* const hb = slot(s) + kSteps * kLanes;  // b, then h
    const int t0 = s * kSteps;
    const int n = min(kSteps, S - t0);
    if (n == kSteps) {
      float ea[kSteps];
#pragma unroll
      for (int x = 0; x < kSteps; ++x) ea[x] = expf(la[x * kLanes + lane]);
#pragma unroll
      for (int x = 0; x < kSteps; ++x) {
        h = step(ea[x], h, hb[x * kLanes + lane]);
        hb[x * kLanes + lane] = h;
      }
    } else {
      for (int x = 0; x < n; ++x) {
        h = step(expf(la[x * kLanes + lane]), h, hb[x * kLanes + lane]);
        hb[x * kLanes + lane] = h;
      }
    }
    __syncwarp();  // the tile's h rows complete
    float* const dst = y + base + static_cast<size_t>(t0) * W;
    if (vec) {
#pragma unroll
      for (int e = 0; e < kSteps * kRuns / kLanes; ++e) {
        const int idx = lane + e * kLanes;
        const int row = idx / kRuns;
        const int run = idx % kRuns;
        if (row < n && c0 + 4 * run < W)
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * W + 4 * run) =
              *reinterpret_cast<const float4*>(hb + row * kLanes + 4 * run);
      }
    } else if (live) {
      for (int row = 0; row < n; ++row)
        dst[static_cast<size_t>(row) * W + lane] = hb[row * kLanes + lane];
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  if (live) h_last[at] = h;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
  // a sequence streams through one-warp blocks with a ring each; a decode
  // step through blocks of kShortWarps warps, no ring
  const int warps = S > 1 ? 1 : kShortWarps;
  const int tiles_w = (W + warps * kLanes - 1) / (warps * kLanes);
  const int vec = W % 4 == 0 && aligned16(log_a) && aligned16(b) && aligned16(y);
  const size_t smem = S > 1 ? kRingBytes : 0;
  rglru_scan_kernel<<<B * tiles_w, warps * kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      log_a, b, h0, y, h_last, S, W, tiles_w, vec);
  return cudaGetLastError();
}

}  // extern "C"
