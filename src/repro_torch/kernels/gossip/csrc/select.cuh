// The exact k-th largest of a row of |payload| bit patterns, by radix
// select: shared by the round kernels (fused_round_cluster.cu: the top-k
// mask's threshold, every tie at it kept) and the compact DSGT wire stage
// (wire_stage_compact.cu: exact k, ties filled toward the lower index).
//
// For x >= 0 the float order is the order of the bits, so the k-th
// largest |payload| counted with multiplicity -- sort(|p|)[len - k], as
// the reference computes it -- is found from the top byte down: each of
// 4 passes histograms the candidates' next 8 bits (a 256-bin histogram a
// warp, in shared memory) and keeps the bin that holds the k-th largest.

#pragma once

#include <cuda_runtime.h>

namespace gossip {

constexpr int kRadixBins = 256;

// One warp finds the k-th largest of key(0) .. key(len - 1) (each a
// non-negative float's bit pattern); `hist` is the warp's kRadixBins ints.
// Returns the threshold on every lane; with `ties`, also how many of the
// k largest equal it (k minus the count strictly above it). Lane l scans
// bins 255 - 8l - 7 .. 255 - 8l.
template <class Key>
__device__ unsigned radix_select(const Key& key, int len, int k, int* hist,
                                 int* ties = nullptr) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  unsigned prefix = 0;
  int krem = k;
  for (int b = lane; b < kRadixBins; b += 32) hist[b] = 0;
  __syncwarp();
  for (int shift = 24; shift >= 0; shift -= 8) {
    const unsigned mask = shift == 24 ? 0u : ~0u << (shift + 8);
    for (int c = lane; c < len; c += 32) {
      const unsigned u = key(c);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncwarp();
    int cnt[8];
    int sum = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      cnt[b] = hist[kRadixBins - 1 - 8 * lane - b];
      sum += cnt[b];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - sum;
    const bool here = excl < krem && krem <= incl;
    unsigned digit = 0;
    int knext = 0;
    if (here) {
      int acc = excl;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (knext == 0 && krem <= acc + cnt[b]) {
          digit = kRadixBins - 1 - 8 * lane - b;
          knext = krem - acc;
        }
        acc += cnt[b];
      }
    }
    const int src = __ffs(__ballot_sync(kAll, here)) - 1;
    digit = __shfl_sync(kAll, digit, src);
    krem = __shfl_sync(kAll, knext, src);
    prefix |= digit << shift;
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 8; ++b) hist[8 * lane + b] = 0;
    __syncwarp();
  }
  // krem is now the threshold's rank among the elements equal to it
  if (ties != nullptr) *ties = krem;
  return prefix;
}

}  // namespace gossip
