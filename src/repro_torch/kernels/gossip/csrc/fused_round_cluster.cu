// The round megakernels for Hopper (sm_90a) on thread-block clusters. One
// launch is one whole communication round of the fused engine: the local
// update, the int8 difference-coded quantization with error feedback
// (top-k masked when topk > 0) and the W mix, on one wire (DSGD) or on
// the tracker and the parameter wire together (DSGT) -- or, with no
// local update, one compressed gossip round of a buffer (the gossip
// stage of core/compression.py).
//
// Replaces the TPU kernels
//   src/repro/kernels/gossip/gossip.py:421  fused_round_pallas     (DSGD)
//   src/repro/kernels/gossip/gossip.py:476  fused_round_gt_pallas  (DSGT)
//   src/repro/kernels/gossip/gossip.py:378  gossip_mix_pallas      (gossip stage)
// and is held bit for bit (recon', res', scales) and within fp32
// summation order (mixed) to the PyTorch twins in ../ref.py.
//
// Bound: HBM bytes. DSGD reads 4 and writes 3 (n, t) fp32 buffers, DSGT
// reads 8 and writes 6, the gossip stage reads 3 and writes 3 (plus the
// (n, t/chunk) scales and the n x n weights). A dense mix is 2n fp32
// operations per element and wire -- at n = 64 on the DSGT round about a
// quarter of the byte bound's time -- and a graph's W_off is sparse.
//
// Design:
//   * A cluster of C blocks owns a scale chunk at a time; block r of the
//     cluster owns columns [r * cols, (r + 1) * cols) of it, for all n
//     rows (the last block may own fewer). The mix is column-local, so
//     the only coupling across blocks is the per-(row, chunk) max and the
//     top-k threshold, and both cross through distributed shared memory.
//     C and cols come from the planner in ../ops.py (plan_round): enough
//     blocks to spread a small round over many SMs, tiles small enough for
//     two blocks an SM on a large one.
//   * The grid is as many clusters as the card holds at once (at most one
//     a chunk); each walks the chunks ci0, ci0 + clusters, ... So W_off
//     (its rows by cp.async) and the mask of its nonzero 4 x 4 blocks are
//     loaded once a block, and a cluster is launched once.
//   * Each input is read once: a chunk's (n, cols) input tiles are copied
//     by cp.async (16 bytes where every row starts 16-byte aligned, 4
//     otherwise) and stay on chip until the mix: the update (h; DSGT also
//     t_half) overwrites its inputs in place as the mix's self term, the
//     payload overwrites g (DSGT: g and g_prev) and then becomes the
//     neighbour view recon' (stale mix: the loaded recon). The next
//     chunk's tiles are copied in as soon as this chunk is done with
//     them: res after the payloads (with error feedback), recon before
//     the mix (without stale mix), the update's inputs after it.
//   * DSGT's two wires run in one sweep: t_half once, both payloads, one
//     cluster barrier for both wires' maxes, both quantized and mixed.
//   * The gossip stage (WIRES = 0) is DSGD without its update, on DSGD's
//     layout: x is the payload's source and the mix's self term and is
//     never overwritten, the payload goes to the second tile (scratch,
//     never loaded), so it loads 3 tiles a chunk, not 4.
//   * The payload pass takes up to 4 rows a warp at once, so the rows'
//     loads and shuffle reductions overlap.
//   * Row maxes cross as stores: each block writes its partial maxes
//     (|payload| >= 0; a max is exact in any order) into its slot of every
//     block, 16 bytes a store, then one cluster barrier, and each block
//     reduces its slots. With top-k, each (wire, row) has an owner block
//     (row % C); the blocks push their |payload| of that row into the
//     owner's row buffer, a warp of the owner finds the exact threshold
//     by a radix select on the bit pattern (select.cuh: 4 passes of 8
//     bits, a 256-bin histogram a warp in shared memory; it measured
//     faster than a 31-step search of the local row) and pushes it to
//     every block; a second
//     barrier. The k-th largest |payload| with multiplicity is what the
//     reference's sort gives, and every tie at it is kept. Nothing crosses
//     but before a barrier, and dense chunks alternate two sets of slots,
//     so a block a chunk ahead never writes slots a peer still reduces
//     (with top-k the second barrier keeps the blocks within a chunk). The
//     first barrier is split (arrive at the start, wait before the first
//     remote access) so that no block reaches a peer that has not started.
//   * The mix is register-blocked: a thread computes 4 rows x 4 columns
//     of one wire over W_off's nonzero 4 x 4 blocks in ascending order,
//     reading W_off and the neighbour tile as float4 from shared memory.
//     Each output sums fmaf over its j in ascending order, then adds
//     w_self * self, as the earlier kernel did; the skipped blocks' terms
//     are exact zeros.
//   * Rounding matches the twin exactly (quantize.cuh's element helpers,
//     -fmad=false).

#include <cooperative_groups.h>

#include "quantize.cuh"
#include "select.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gossip;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // the most rows a warp takes at once
constexpr int kGossip = 0;  // the wire count that names the gossip stage

// One wire's buffers. recon/res are read, the rest written.
struct WireIO {
  const float* recon;
  const float* res;
  float* mixed;
  float* new_recon;
  float* new_res;
  float* scales;
};

struct Params {
  // gossip stage: in[0] = x; DSGD: in[0..1] = x, g; DSGT: in[0..3] = x,
  // t, g, g_prev
  const float* in[4];
  WireIO wire[2];  // DSGT: wire 0 the parameter wire, 1 the tracker wire
  const float* w_off;
  const float* w_self;
  float alpha;
  int n, t, chunk, n_chunks, topk;
  int clusters;  // C, blocks a cluster
  int cols;      // columns a block owns (its tiles' row stride)
  int grid;      // clusters launched, each walking its share of the chunks
  int vec;       // every row starts 16-byte aligned: 16-byte copies
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// The shared-memory layout, in 4-byte words, from the tile sizes alone
// (the host and the kernel compute it alike; ../ops.py round_smem_bytes
// mirrors it). Every region starts 16-byte aligned. `wires` counts the
// wires (1 or 2): the gossip stage takes DSGD's layout.
struct Layout {
  size_t tiles, woff, wself, jmask, lmax, slots, slot_words, gmax, thr, rowbuf,
      total;
  __host__ __device__ Layout(int wires, int n, int cols, int chunk,
                             int clusters, bool topk) {
    const size_t n_in = wires == 1 ? 4 : 8;
    const size_t wn = static_cast<size_t>(wires) * n;
    const size_t wn4 = round4(static_cast<int>(wn));
    const size_t owned = (wn + clusters - 1) / clusters;
    const size_t hist_words = topk ? static_cast<size_t>(kWarps) * kRadixBins : 0;
    slot_words = clusters * wn4 > hist_words ? clusters * wn4 : hist_words;
    tiles = 0;
    woff = tiles + n_in * n * cols;
    wself = woff + static_cast<size_t>(round4(n)) * round4(n);
    jmask = wself + round4(n);  // one 64-bit mask a row group
    lmax = jmask + round4(2 * (round4(n) / 4));
    slots = lmax + wn4;  // two sets (dense) or one (top-k: the histograms
                         // reuse it once it is reduced)
    gmax = slots + (topk ? 1 : 2) * slot_words;
    thr = gmax + wn4;
    rowbuf = thr + (topk ? wn4 : 0);
    total = rowbuf + (topk ? owned * chunk : 0);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Issue the copies of one (n, cols_here) tile: global row stride t,
// shared row stride `stride`.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int n,
                                          size_t t, int stride, int cols_here,
                                          bool vec) {
  if (vec) {
    const int v4 = cols_here / 4;
    for (int idx = threadIdx.x; idx < n * v4; idx += kThreads) {
      const int r = idx / v4, c = (idx % v4) * 4;
      cp_async16(dst + r * stride + c, src + r * t + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * cols_here; idx += kThreads) {
      const int r = idx / cols_here, c = idx % cols_here;
      cp_async4(dst + r * stride + c, src + r * t + c);
    }
  }
}

template <int WIRES, bool EF, bool DC, bool STALE, bool TOPK>
__global__ void __launch_bounds__(kThreads, 2)
round_kernel(const Params p) {
  // WIRES 0 is the gossip stage: one wire with no local update
  constexpr bool GOSSIP = WIRES == kGossip;
  constexpr int NW = GOSSIP ? 1 : WIRES;  // wires
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.clusters;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / C;
  const int cols_here = min(p.cols, p.chunk - rank * p.cols);
  const int n = p.n, S = p.cols, n_pad = round4(n);
  const int wn = NW * n, wn4 = round4(wn);
  const size_t tile = static_cast<size_t>(n) * S;
  const Layout lay(NW, n, S, p.chunk, C, TOPK);
  float* woff = smem + lay.woff;  // woff[i * n_pad + j] = W_off[i][j]
  float* wself = smem + lay.wself;
  // bit b of jmask[rg]: W_off has a nonzero in rows 4 rg..4 rg + 3,
  // columns 4 b..4 b + 3
  unsigned long long* jmask =
      reinterpret_cast<unsigned long long*>(smem + lay.jmask);
  float* lmax = smem + lay.lmax;  // this block's row maxes
  float* gmax = smem + lay.gmax;  // the chunk's row maxes
  float* thr = smem + lay.thr;
  unsigned* rowbuf = reinterpret_cast<unsigned*>(smem + lay.rowbuf);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // rows a warp takes at once in the payload pass: enough to cover the
  // rows with every warp, at most kRows
  const int rows = min(kRows, (n + kWarps - 1) / kWarps);

  // Tiles: DSGD [x, g, recon, res]; gossip stage [x, scratch, recon,
  // res]; DSGT [x, t, g, g_prev, recon_x, res_x, recon_t, res_t]. Per
  // wire: the self term (h / t_half in place of x / t; the gossip
  // stage's x itself), the payload (in place of g / g_prev; the gossip
  // stage's scratch tile), later the neighbour view, recon, res.
  float* self_t[NW];
  float* pay_t[NW];
  float* rec_t[NW];
  float* res_t[NW];
  if constexpr (NW == 1) {
    self_t[0] = smem;
    pay_t[0] = smem + tile;
    rec_t[0] = smem + 2 * tile;
    res_t[0] = smem + 3 * tile;
  } else {
    self_t[0] = smem;            // x -> h
    self_t[1] = smem + tile;     // t -> t_half
    pay_t[0] = smem + 3 * tile;  // g_prev -> payload_x
    pay_t[1] = smem + 2 * tile;  // g -> payload_t
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      rec_t[w] = smem + (4 + 2 * w) * tile;
      res_t[w] = smem + (5 + 2 * w) * tile;
    }
  }
  // a chunk's copies: the update's inputs (the gossip stage's x), and
  // each wire's recon and res
  auto load_update = [&](size_t col0) {
#pragma unroll
    for (int b = 0; b < (GOSSIP ? 1 : 2 * NW); ++b) {
      load_tile(smem + b * tile, p.in[b] + col0, n, p.t, S, cols_here, p.vec);
    }
  };
  auto load_rec = [&](size_t col0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (DC || STALE) {
        load_tile(rec_t[w], p.wire[w].recon + col0, n, p.t, S, cols_here, p.vec);
      }
    }
  };
  auto load_res = [&](size_t col0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      load_tile(res_t[w], p.wire[w].res + col0, n, p.t, S, cols_here, p.vec);
    }
  };
  auto col0_of = [&](int ci) {
    return static_cast<size_t>(ci) * p.chunk + static_cast<size_t>(rank) * S;
  };

  cluster_arrive();  // the first barrier: this block has started

  // the first chunk's tiles and W_off (16-byte copies where its rows
  // allow) all in flight at once; W_off's pad rows and columns zero
  const int ci0 = blockIdx.x / C;
  load_update(col0_of(ci0));
  load_rec(col0_of(ci0));
  load_res(col0_of(ci0));
  const bool wvec = n % 4 == 0 && reinterpret_cast<uintptr_t>(p.w_off) % 16 == 0;
  load_tile(woff, p.w_off, n, n, n_pad, n, wvec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = threadIdx.x; k < n_pad * n_pad; k += kThreads) {
    if (k / n_pad >= n || k % n_pad >= n) woff[k] = 0.f;
  }
  for (int i = threadIdx.x; i < n_pad; i += kThreads) {
    wself[i] = i < n ? p.w_self[i] : 0.f;
  }
  for (int k = wn + threadIdx.x; k < wn4; k += kThreads) lmax[k] = 0.f;
  for (int k = threadIdx.x; k < n_pad / 4; k += kThreads) jmask[k] = 0ull;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  cluster_wait();
  // the nonzero 4 x 4 blocks of W_off (a graph's W is sparse; the mix
  // skips the zero blocks, whose terms add exact zeros)
  for (int k = threadIdx.x; k < (n_pad / 4) * (n_pad / 4); k += kThreads) {
    const int rg = k / (n_pad / 4), jb = k % (n_pad / 4);
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(woff + (rg * 4 + r) * n_pad + jb * 4);
      any = any || v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    }
    if (any) atomicOr(jmask + rg, 1ull << jb);
  }

  // The cluster walks its chunks ci0, ci0 + n_clusters, ...; the next
  // chunk's res tiles are copied in once spent (after the payloads with
  // error feedback), its recon tiles while this chunk mixes, its update
  // inputs once the mix is done.
  for (int ci = ci0, it = 0; ci < p.n_chunks; ci += n_clusters, ++it) {
    const size_t col0 = col0_of(ci);
    const bool more = ci + n_clusters < p.n_chunks;
    if (it > 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    // dense rounds alternate two sets of slots, so a block a chunk ahead
    // never writes the set a block still reduces; with top-k the second
    // barrier orders them and the one set also holds the histograms
    float* slots = smem + lay.slots + (TOPK ? 0 : (it & 1) * lay.slot_words);

    // payloads, a warp up to 4 rows at a time (independent chains): the
    // update in place, both wires' payloads, the row maxes, (top-k) the
    // row to its owner
    for (int i0 = warp * rows; i0 < n; i0 += kWarps * rows) {
      float m[kRows][NW];
      unsigned* owner[kRows][NW];  // (top-k) the row's slot in its owner's buffer
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          m[r][w] = 0.f;
          const int k = w * n + i0 + r;
          owner[r][w] = TOPK && r < rows && i0 + r < n
                            ? cluster.map_shared_rank(rowbuf, k % C) +
                                  static_cast<size_t>(k / C) * p.chunk + rank * S
                            : nullptr;
        }
      }
      for (int c = lane; c < cols_here; c += 32) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= rows || i0 + r >= n) break;
          const size_t o = static_cast<size_t>(i0 + r) * S + c;
          float src[NW];
          if constexpr (GOSSIP) {
            src[0] = smem[o];
          } else if constexpr (NW == 1) {
            src[0] = __fsub_rn(smem[o], __fmul_rn(p.alpha, pay_t[0][o]));
          } else {
            const float th = __fsub_rn(__fadd_rn(self_t[1][o], pay_t[1][o]),
                                       pay_t[0][o]);
            src[1] = th;
            src[0] = __fsub_rn(self_t[0][o], __fmul_rn(p.alpha, th));
          }
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const float pl = payload_elem<EF>(src[w], DC ? rec_t[w][o] : 0.f,
                                              EF ? res_t[w][o] : 0.f);
            if (!GOSSIP) self_t[w][o] = src[w];
            pay_t[w][o] = pl;
            m[r][w] = fmaxf(m[r][w], fabsf(pl));
            if (TOPK) owner[r][w][c] = __float_as_uint(fabsf(pl));
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            m[r][w] = fmaxf(m[r][w], __shfl_xor_sync(kFullMask, m[r][w], off));
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if (r < rows && i0 + r < n) lmax[w * n + i0 + r] = m[r][w];
          }
        }
      }
    }
    __syncthreads();
    // with error feedback res is spent: the next chunk's may come in
    if (EF && more) load_res(col0_of(ci + n_clusters));
    // this block's row maxes into its slot of every block, 16 bytes a store
    for (int idx = threadIdx.x; idx < C * (wn4 / 4); idx += kThreads) {
      const int rr = idx / (wn4 / 4), q = (idx % (wn4 / 4)) * 4;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(slots, rr) + rank * wn4 + q) =
          *reinterpret_cast<const float4*>(lmax + q);
    }
    cluster_arrive();
    cluster_wait();
    for (int k = threadIdx.x; k < wn; k += kThreads) {
      float m = 0.f;
      for (int rr = 0; rr < C; ++rr) m = fmaxf(m, slots[rr * wn4 + k]);
      gmax[k] = m;
    }
    __syncthreads();

    if (TOPK) {
      // the owned rows' thresholds, a warp a row, to every block
      int* hist = reinterpret_cast<int*>(slots) + warp * kRadixBins;
      const int owned = (wn - rank + C - 1) / C;
      for (int s = warp; s < owned; s += kWarps) {
        const int k = s * C + rank;
        const unsigned* row = rowbuf + static_cast<size_t>(s) * p.chunk;
        const unsigned bits =
            radix_select([row](int c) { return row[c]; }, p.chunk, p.topk, hist);
        if (lane < C) {
          *(cluster.map_shared_rank(thr, lane) + k) = __uint_as_float(bits);
        }
      }
      cluster_arrive();
      cluster_wait();
    }

    // quantize, a warp a row: recon', res' out, the neighbour view in place
    for (int i = warp; i < n; i += kWarps) {
      const size_t ro = static_cast<size_t>(i) * S;
      const size_t go = static_cast<size_t>(i) * p.t + col0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const WireIO io = p.wire[w];
        RowScale rs = scale_of(gmax[w * n + i]);
        if (TOPK) rs.thr = thr[w * n + i];
        if (rank == 0 && lane == 0) {
          io.scales[static_cast<size_t>(i) * p.n_chunks + ci] = rs.scale;
        }
        for (int c = lane; c < cols_here; c += 32) {
          const float pl = pay_t[w][ro + c];
          const float dq = __fmul_rn(quantize_elem<TOPK>(pl, rs), rs.scale);
          const float nr = __fadd_rn(DC ? rec_t[w][ro + c] : 0.f, dq);
          io.new_recon[go + c] = nr;
          io.new_res[go + c] = EF ? __fsub_rn(pl, dq) : res_t[w][ro + c];
          if (!STALE) pay_t[w][ro + c] = nr;
        }
      }
    }
    __syncthreads();
    // the mix reads neither res nor (but with stale mix) recon
    if (more && !STALE) load_rec(col0_of(ci + n_clusters));
    if (more && !EF) load_res(col0_of(ci + n_clusters));

    // mixed = W_off @ nbr + w_self * self, 4 rows x 4 columns a thread
    const int rgs = n_pad / 4, cgs = S / 4;
    for (int item = threadIdx.x; item < NW * rgs * cgs; item += kThreads) {
      const int cg4 = item % cgs, rg = (item / cgs) % rgs;
      const bool w1 = NW == 2 && item >= cgs * rgs;  // the tracker wire
      const int c = cg4 * 4;
      if (c >= cols_here) continue;
      const float* nbr = (STALE ? (w1 ? rec_t[NW - 1] : rec_t[0])
                                : (w1 ? pay_t[NW - 1] : pay_t[0])) + c;
      const float* self0 = (w1 ? self_t[NW - 1] : self_t[0]) + c;
      float* mixed = (w1 ? p.wire[1].mixed : p.wire[0].mixed) + col0 + c;
      const float* wrow = woff + rg * 4 * n_pad;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      }
      // 4 neighbours at a time, over W_off's nonzero blocks in ascending
      // order: 4 rows of W_off and 4 rows of the tile as float4, each
      // accumulator summed in j order
      for (unsigned long long mk = jmask[rg]; mk != 0ull; mk &= mk - 1) {
        const int j = 4 * (__ffsll(static_cast<long long>(mk)) - 1);
        float4 wv[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wv[r] = *reinterpret_cast<const float4*>(wrow + r * n_pad + j);
          v[r] = j + r < n ? *reinterpret_cast<const float4*>(nbr + (j + r) * S)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (j + jj >= n) break;
          const float vc[4] = {v[jj].x, v[jj].y, v[jj].z, v[jj].w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float wr = jj == 0 ? wv[r].x : jj == 1 ? wv[r].y : jj == 2 ? wv[r].z : wv[r].w;
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wr, vc[q], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = rg * 4 + r;
        if (i >= n) break;
        const float* self = self0 + static_cast<size_t>(i) * S;
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          out[q] = __fadd_rn(acc[r][q], __fmul_rn(wself[i], self[q]));
        }
        float* dst = mixed + static_cast<size_t>(i) * p.t;
        if (p.vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
          for (int q = 0; q < 4 && c + q < cols_here; ++q) dst[q] = out[q];
        }
      }
    }
    if (more) {
      __syncthreads();
      load_update(col0_of(ci + n_clusters));
      if (STALE) load_rec(col0_of(ci + n_clusters));
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
}

using KernelFn = void (*)(Params);

// The 16 flag combinations of one wire count (0 the gossip stage, 1
// DSGD, 2 DSGT), indexed ef<<3|dc<<2|stale<<1|topk.
#define FLAG_ROW(W, EF, DC)                                              \
  round_kernel<W, EF, DC, false, false>, round_kernel<W, EF, DC, false, true>, \
      round_kernel<W, EF, DC, true, false>, round_kernel<W, EF, DC, true, true>
#define FLAG_TABLE(W)                                                  \
  { FLAG_ROW(W, false, false), FLAG_ROW(W, false, true),               \
    FLAG_ROW(W, true, false), FLAG_ROW(W, true, true) }

const KernelFn kTable[3][16] = {FLAG_TABLE(kGossip), FLAG_TABLE(1), FLAG_TABLE(2)};

KernelFn kernel_for(int wires, int ef, int dc, int stale, int topk) {
  const int idx = (ef ? 8 : 0) | (dc ? 4 : 0) | (stale ? 2 : 0) | (topk > 0 ? 1 : 0);
  return kTable[wires][idx];
}

size_t smem_bytes(int wires, int n, int chunk, int clusters, int cols, int topk) {
  const int nw = wires == kGossip ? 1 : wires;
  return sizeof(float) * Layout(nw, n, cols, chunk, clusters, topk > 0).total;
}

cudaLaunchConfig_t config(int grid, int clusters, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare(KernelFn fn, size_t smem, int clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && clusters > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

int launch(Params& p, int wires, int ef, int dc, int stale, void* stream) {
  const int n_bufs = wires == kGossip ? 1 : 2 * wires;
  bool aligned = p.t % 4 == 0 && p.chunk % 4 == 0;
  const void* ptrs[] = {p.in[0], p.in[1], p.in[2], p.in[3],
                        p.wire[0].recon, p.wire[0].res, p.wire[0].mixed,
                        p.wire[0].new_recon, p.wire[0].new_res,
                        p.wire[1].recon, p.wire[1].res, p.wire[1].mixed,
                        p.wire[1].new_recon, p.wire[1].new_res};
  for (int k = 0; k < 14; ++k) {
    const bool used = k < 4 ? k < n_bufs : (k < 9 || wires == 2);
    if (used) aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[k]) % 16 == 0;
  }
  p.vec = aligned;
  p.n_chunks = p.t / p.chunk;
  const KernelFn fn = kernel_for(wires, ef, dc, stale, p.topk);
  const size_t smem = smem_bytes(wires, p.n, p.chunk, p.clusters, p.cols, p.topk);
  cudaError_t err = prepare(fn, smem, p.clusters);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const int grid = p.grid < p.n_chunks ? p.grid : p.n_chunks;
  const cudaLaunchConfig_t cfg = config(grid, p.clusters, smem,
                                        static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fn, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a round of `wires` wires (0:
// the gossip stage, on DSGD's layout) with clusters of `clusters` blocks
// owning `cols` columns each (what the planner in ../ops.py computes too).
size_t fused_round_cluster_smem_bytes(int wires, int n, int chunk, int clusters,
                                      int cols, int topk) {
  return smem_bytes(wires, n, chunk, clusters, cols, topk);
}

// How many such clusters the card can hold at once (0: the cluster does
// not fit); negative: the CUDA error.
int fused_round_cluster_max_active(int wires, int n, int chunk, int clusters,
                                   int cols, int topk, int ef, int dc, int stale) {
  const KernelFn fn = kernel_for(wires, ef, dc, stale, topk);
  const size_t smem = smem_bytes(wires, n, chunk, clusters, cols, topk);
  cudaError_t err = prepare(fn, smem, clusters);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, clusters, smem, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns the launch's error.
// topk: columns kept per (row, chunk) by the top-k mask, 0 for all;
// clusters, cols: the plan (../ops.py plan_round); grid: how many
// clusters to launch (at most one a chunk; the card's resident count).
int fused_round_cluster_launch(const float* x, const float* g,
                               const float* recon, const float* res,
                               const float* w_off, const float* w_self,
                               float alpha, float* mixed, float* new_recon,
                               float* new_res, float* scales, int n, int t,
                               int chunk, int topk, int ef, int dc, int stale,
                               int clusters, int cols, int grid, void* stream) {
  Params p = {};
  p.in[0] = x;
  p.in[1] = g;
  p.wire[0] = WireIO{recon, res, mixed, new_recon, new_res, scales};
  p.w_off = w_off;
  p.w_self = w_self;
  p.alpha = alpha;
  p.n = n;
  p.t = t;
  p.chunk = chunk;
  p.topk = topk;
  p.clusters = clusters;
  p.cols = cols;
  p.grid = grid;
  return launch(p, 1, ef, dc, stale, stream);
}

// The gossip stage: mixed = W_off @ recon' + w_self * x (stale: against
// the input recon), with recon', res' and the scales of x's payload.
int gossip_mix_cluster_launch(const float* x, const float* recon,
                              const float* res, const float* w_off,
                              const float* w_self, float* mixed,
                              float* new_recon, float* new_res, float* scales,
                              int n, int t, int chunk, int topk, int ef, int dc,
                              int stale, int clusters, int cols, int grid,
                              void* stream) {
  Params p = {};
  p.in[0] = x;
  p.wire[0] = WireIO{recon, res, mixed, new_recon, new_res, scales};
  p.w_off = w_off;
  p.w_self = w_self;
  p.n = n;
  p.t = t;
  p.chunk = chunk;
  p.topk = topk;
  p.clusters = clusters;
  p.cols = cols;
  p.grid = grid;
  return launch(p, kGossip, ef, dc, stale, stream);
}

int fused_round_gt_cluster_launch(
    const float* x, const float* t, const float* g, const float* gp,
    const float* recon_x, const float* res_x, const float* recon_t,
    const float* res_t, const float* w_off, const float* w_self, float alpha,
    float* mixed_x, float* mixed_t, float* new_recon_x, float* new_res_x,
    float* new_recon_t, float* new_res_t, float* scales_x, float* scales_t,
    int n, int tot, int chunk, int topk, int ef, int dc, int stale,
    int clusters, int cols, int grid, void* stream) {
  Params p = {};
  p.in[0] = x;
  p.in[1] = t;
  p.in[2] = g;
  p.in[3] = gp;
  p.wire[0] = WireIO{recon_x, res_x, mixed_x, new_recon_x, new_res_x, scales_x};
  p.wire[1] = WireIO{recon_t, res_t, mixed_t, new_recon_t, new_res_t, scales_t};
  p.w_off = w_off;
  p.w_self = w_self;
  p.alpha = alpha;
  p.n = n;
  p.t = tot;
  p.chunk = chunk;
  p.topk = topk;
  p.clusters = clusters;
  p.cols = cols;
  p.grid = grid;
  return launch(p, 2, ef, dc, stale, stream);
}

}  // extern "C"
