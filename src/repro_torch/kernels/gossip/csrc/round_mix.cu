// The neighbour mix of the round kernels' two-pass route, for Hopper
// (sm_90a):
//
//   mixed = W_off @ nbr + w_self * self
//
// on one wire (DSGD, the gossip stage) or two (DSGT: the parameter and
// the tracker wire, one W). Pass 1 (wire_stage.cu) has written recon',
// res', the scales and the self term (h; DSGT also t_half); nbr is recon'
// or, under the pipelined schedule's stale mix, the input recon.
//
// Replaces no TPU kernel of its own: it is the mix inside the TPU round
// kernels
//   src/repro/kernels/gossip/gossip.py:421  fused_round_pallas     (DSGD)
//   src/repro/kernels/gossip/gossip.py:476  fused_round_gt_pallas  (DSGT)
//   src/repro/kernels/gossip/gossip.py:378  gossip_mix_pallas      (gossip stage)
// (the W-row mix of `_quantize_mix`, gossip.py:199-216), for the
// federations whose round the one-pass cluster kernel
// (fused_round_cluster.cu) cannot hold: it keeps W_off whole in each
// block's shared memory beside an (n, cols) tile of every input, which
// past about 130-170 nodes no longer fits. Held
// within fp32 summation order to the PyTorch twin (../ref.py
// round_mix_ref); it sums in the one-pass kernel's order, so where both
// run it gives the same bits.
//
// Bound: HBM bytes. Each wire reads nbr and self and writes mixed, 12 B
// an element, plus W_off and w_self; the mix is 2 operations a nonzero
// of W_off an element, far under the fp32 peak for a graph's sparse W
// (a dense W at n = 512 is about 1 operation a byte).
//
// Design (simple and right first):
//   * A block owns a row group (4 rows) and walks column tiles of 1,024
//     (4 columns a thread, float4 where every row is 16-byte aligned)
//     tile0, tile0 + splits, ... (blockIdx.y the split). The row groups of
//     a split run side by side on the same tiles, so the neighbour rows
//     they share come from L2.
//   * The block lists its row group's nonzero 4 x 4 blocks of W_off on the
//     device, from the W it is handed (the dynamic round hands a new W
//     every round; no host sync): a thread a column group tests its 16
//     weights, and a ballot and the warps' counts give each nonzero block
//     its slot in ascending order, its weights beside it in shared memory.
//     A ring at n = 1,024 then reads 3 blocks of neighbour rows a row
//     group, a complete graph all of them. Up to kWindow column groups
//     (n <= 2,048) are listed once a block; past that the block lists a
//     window at a time, again for each tile.
//   * Each output sums fmaf over the listed blocks' j in ascending order,
//     then adds w_self * self, each rounded once (as fused_round_cluster.cu
//     does; the gossip build passes -fmad=false).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4 * kThreads;  // columns a block covers a tile
constexpr int kWindow = 512;         // column groups a block lists at once
constexpr unsigned kFullMask = 0xffffffffu;

struct MixWire {
  const float* nbr;
  const float* self;
  float* mixed;
};

struct MixParams {
  MixWire wire[2];
  const float* w_off;
  const float* w_self;
  int n, t, wires;
};

// The nonzero 4 x 4 blocks of W_off in rows 4 rg .. 4 rg + 3 among column
// groups [g0, g1), in ascending order: their column groups into list,
// their weights (a float4 a row) into wblk. Every thread of the block
// calls it. Returns the count.
__device__ int list_blocks(const float* __restrict__ w_off, int n, int rg,
                           int g0, int g1, int* list, float4* wblk,
                           int* warp_counts) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int count = 0;
  for (int base = g0; base < g1; base += kThreads) {
    const int jg = base + threadIdx.x;
    float w[4][4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * rg + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jg + jj;
        w[r][jj] = jg < g1 && i < n && j < n
                       ? w_off[static_cast<size_t>(i) * n + j]
                       : 0.f;
        any = any || w[r][jj] != 0.f;
      }
    }
    const unsigned ballot = __ballot_sync(kFullMask, any);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) before += warp_counts[k];
      total += warp_counts[k];
    }
    if (any) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      list[slot] = jg;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wblk[4 * slot + r] = make_float4(w[r][0], w[r][1], w[r][2], w[r][3]);
      }
    }
    count += total;
    __syncthreads();  // warp_counts is reused
  }
  return count;
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int c, int t,
                                      float v[4]) {
  if (VEC) {
    const float4 f = *reinterpret_cast<const float4*>(row + c);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = c + q < t ? row[c + q] : 0.f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
round_mix_kernel(const MixParams p) {
  __shared__ int list[kWindow];
  __shared__ float4 wblk[4 * kWindow];
  __shared__ int warp_counts[kWarps];
  const int n = p.n, rg = blockIdx.x;
  const size_t t = p.t;
  const int groups = (n + 3) / 4;
  const bool one_window = groups <= kWindow;
  int count = one_window
                  ? list_blocks(p.w_off, n, rg, 0, groups, list, wblk, warp_counts)
                  : 0;
  const int n_tiles = (p.t + kCols - 1) / kCols;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int c = tile * kCols + 4 * threadIdx.x;
    const bool live = c < p.t;
    for (int wi = 0; wi < p.wires; ++wi) {
      const MixWire io = wi == 0 ? p.wire[0] : p.wire[1];  // no local copy of p
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      }
      for (int g0 = 0; g0 < groups; g0 += kWindow) {
        if (!one_window) {
          const int g1 = g0 + kWindow < groups ? g0 + kWindow : groups;
          count = list_blocks(p.w_off, n, rg, g0, g1, list, wblk, warp_counts);
        }
        if (live) {
          for (int e = 0; e < count; ++e) {
            const int j = 4 * list[e];
            float v[4][4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (j + jj < n) {
                load4<VEC>(io.nbr + static_cast<size_t>(j + jj) * t, c, p.t, v[jj]);
              } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) v[jj][q] = 0.f;
              }
            }
            float4 wv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) wv[r] = wblk[4 * e + r];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (j + jj >= n) break;
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float wr = jj == 0   ? wv[r].x
                                 : jj == 1 ? wv[r].y
                                 : jj == 2 ? wv[r].z
                                           : wv[r].w;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  acc[r][q] = fmaf(wr, v[jj][q], acc[r][q]);
                }
              }
            }
          }
        }
        if (!one_window) __syncthreads();  // the next window rewrites the list
      }
      if (!live) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * rg + r;
        if (i >= n) break;
        const size_t row = static_cast<size_t>(i) * t;
        float self[4], out[4];
        load4<VEC>(io.self + row, c, p.t, self);
        const float ws = p.w_self[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          out[q] = __fadd_rn(acc[r][q], __fmul_rn(ws, self[q]));
        }
        float* dst = io.mixed + row + c;
        if (VEC) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
          for (int q = 0; q < 4 && c + q < p.t; ++q) dst[q] = out[q];
        }
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// mixed_w = W_off @ nbr_w + w_self * self_w for the `wires` (1 or 2) wires
// given (the second wire's pointers null for one), each (n, t) fp32
// row-major; w_off (n, n), w_self (n,). The grid is one block a row group
// by `splits` column splits (../ops.py mix_splits). Launches on `stream`
// and returns the launch's error.
int round_mix_launch(const float* w_off, const float* w_self,
                     const float* nbr0, const float* self0, float* mixed0,
                     const float* nbr1, const float* self1, float* mixed1,
                     int n, int t, int wires, int splits, void* stream) {
  MixParams p = {};
  p.wire[0] = MixWire{nbr0, self0, mixed0};
  p.wire[1] = MixWire{nbr1, self1, mixed1};
  p.w_off = w_off;
  p.w_self = w_self;
  p.n = n;
  p.t = t;
  p.wires = wires;
  const bool vec = t % 4 == 0 && aligned16(nbr0) && aligned16(self0) &&
                   aligned16(mixed0) && aligned16(nbr1) && aligned16(self1) &&
                   aligned16(mixed1);
  const dim3 grid(static_cast<unsigned>((n + 3) / 4), static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    round_mix_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    round_mix_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
