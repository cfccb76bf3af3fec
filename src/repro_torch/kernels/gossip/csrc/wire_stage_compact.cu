// Compact top-k wire-stage kernels for Hopper (sm_90a): the wire stage
// with an EXACT-k epilogue -- local update + difference coding + the k
// largest |payload| of each (row, chunk) + int8 quantization of those
// survivors + error feedback -- emitting only what crosses the wire:
// k int8 values, k int16/int32 in-chunk positions (or, BITMAP, the
// values in ascending-position order and a chunk/8-byte LSB-first
// presence bitmap) and one fp32 scale per chunk. The sharded engine
// (ShardedFusedEngine) all-gathers those buffers and rebuilds the dense
// dq on the receiving side.
//
// Replaces the TPU kernels
//   src/repro/kernels/gossip/gossip.py:853  wire_stage_compact_pallas     (DSGD)
//   src/repro/kernels/gossip/gossip.py:926  wire_stage_gt_compact_pallas  (DSGT)
// and is held bit for bit (h, t_half, q, positions or bitmap, scales,
// recon', res') to the PyTorch twins in ../ref.py.
//
// Bound: HBM bytes. DSGD reads 4 fp32 (n, t) buffers and writes h,
// recon', res' (28 B per element) plus the compact payload (k/chunk of
// the int8 and index bytes); DSGT reads 8 and writes 6, 56 B per
// element. Selection is latency: what it costs in operations is far
// under the bytes' time.
//
// DSGD (wire_stage_compact_kernel; simple and right first, it reuses what
// wire_stage.cu proved): one warp owns one (row, chunk), the payload row
// in a per-warp shared buffer (quantize.cuh's payload_row). Selection: the
// k-th largest |payload| counted with multiplicity (topk_threshold, a
// 31-step bit-pattern search) is the threshold; every column above it is
// kept, and columns equal to it are kept by ascending index until k are
// filled (ballot + popc prefix), which is jax.lax.top_k's tie rule. The
// same pass lists the survivors' positions in ascending order in shared
// memory and keeps the per-32-column selection masks. The wire order of
// top_k (descending |payload|, ties by index) is each survivor's rank
// among the survivors: #{|p_j| > |p_i|} + #{j < i : |p_j| = |p_i|} -- a
// column that outranks a survivor is itself a survivor, so counting over
// the k survivors is enough. scale = max|payload| / 127 (the largest
// column always survives); dq is 0.0 + q * scale on survivors and +0.0
// elsewhere, as the reference's scatter into zeros gives it.
//
// DSGT (wire_stage_gt_compact_kernel): a block of 128 threads owns a
// (row, chunk) and both wires, a thread 4 adjacent columns at a time
// (16-byte loads and stores where every row is 16-byte aligned).
//   * One sweep computes t_half once and both payloads, writes h and
//     t_half, and keeps both payload rows in shared memory; the row maxes
//     are block reductions.
//   * The thresholds: warp 0 runs the tracker wire's radix select
//     (select.cuh: 4 passes of 8 bits, a 256-bin histogram a warp) while
//     warp 1 runs the parameter wire's. The select also returns how many
//     columns at the threshold the k largest take (the ties to fill).
//   * The tie fill, spread over the block: each thread counts its columns
//     above and at the threshold, a warp scan and the warps' totals give
//     every column its exclusive counts, so a column at the threshold is
//     kept when fewer than `ties` equal columns precede it, and a kept
//     column's slot in ascending order is (above before it) + min(equal
//     before it, ties). The bitmap's values go straight to their slots and
//     its bytes from lane pairs; the positions encodings list the
//     survivors (position, |payload| bits) in shared memory and k threads
//     each rank one by k compares. recon' and res' come out of the same
//     pass (recon and, without error feedback, res read again: they were
//     read a few microseconds before and are in L2).
//   * Chunks wider than 512 columns take the passes in steps of 512 with
//     the counts carried over. Where the two payload rows do not fit one
//     block's shared memory (a 32,776-column chunk), the block runs the
//     wires one after the other in the same launch: the tracker wire,
//     then the parameter wire (t_half computed again from t, g, g_prev).
//     ../ops.py compact_gt_plan chooses, from the shape.

#include "quantize.cuh"
#include "select.cuh"

namespace {

using namespace gossip;

constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 48 * 1024;

enum Encoding { kPos16 = 0, kPos32 = 1, kBitmap = 2 };

// Per-warp shared memory: the payload row (chunk floats), the survivors'
// positions (k ints) and the selection masks (one word per 32 columns).
__host__ __device__ size_t warp_bytes(int chunk, int k) {
  return sizeof(float) * static_cast<size_t>(chunk) +
         sizeof(int) * static_cast<size_t>(k) +
         sizeof(unsigned) * static_cast<size_t>((chunk + 31) / 32);
}

int warps_per_block(int chunk, int k) {
  const size_t w = kSmemBudget / warp_bytes(chunk, k);
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : static_cast<int>(w));
}

size_t smem_bytes(int chunk, int k) {
  return warp_bytes(chunk, k) * warps_per_block(chunk, k);
}

struct Smem {
  float* trow;
  int* spos;
  unsigned* smask;
};

// The outputs of one compact wire. idx is int16_t*, int32_t* or uint8_t*
// (the bitmap) by the kernel's Encoding.
struct CompactOut {
  int8_t* q;
  void* idx;
  float* scales;
  float* new_recon;
  float* new_res;
};

__device__ __forceinline__ unsigned mag_bits(float p) {
  return __float_as_uint(fabsf(p));
}

__device__ __forceinline__ float quantize(float p, float safe) {
  return fminf(fmaxf(rintf(__fdiv_rn(p, safe)), -127.f), 127.f);
}

// The stage on one (row i, chunk ci) of one wire; src to h_out.
template <bool EF, bool DC, int ENC, class Src>
__device__ void compact_stage(const Src& src, const float* __restrict__ recon,
                              const float* __restrict__ res,
                              float* __restrict__ h_out, const CompactOut& out,
                              int i, int ci, const Smem& sm,
                              const Geometry& geo) {
  const int lane = threadIdx.x % 32;
  const int chunk = geo.chunk, k = geo.topk;
  const size_t row =
      static_cast<size_t>(i) * geo.t + static_cast<size_t>(ci) * chunk;
  const float m =
      payload_row<EF, DC>(src, recon, res, row, chunk, sm.trow, h_out);
  const float scale = __fdiv_rn(m, 127.f);
  const float safe = scale > 0.f ? scale : 1.f;
  const unsigned thr = __float_as_uint(topk_threshold(sm.trow, chunk, k));

  // Columns strictly above the threshold are all kept; `need` columns
  // equal to it are kept by ascending index.
  int above = 0;
  for (int c0 = 0; c0 < chunk; c0 += 32) {
    const int c = c0 + lane;
    above += __popc(__ballot_sync(kFullMask, c < chunk && mag_bits(sm.trow[c]) > thr));
  }
  const int need = k - above;
  const unsigned below_me = (1u << lane) - 1u;
  int eq_seen = 0, sel_seen = 0;
  for (int c0 = 0; c0 < chunk; c0 += 32) {
    const int c = c0 + lane;
    const unsigned mb = c < chunk ? mag_bits(sm.trow[c]) : 0u;
    const bool eq = c < chunk && mb == thr;
    const unsigned eq_mask = __ballot_sync(kFullMask, eq);
    const bool sel = (c < chunk && mb > thr) ||
                     (eq && eq_seen + __popc(eq_mask & below_me) < need);
    const unsigned sel_mask = __ballot_sync(kFullMask, sel);
    if (sel) sm.spos[sel_seen + __popc(sel_mask & below_me)] = c;
    if (lane == 0) sm.smask[c0 / 32] = sel_mask;
    if (ENC == kBitmap && lane < 4 && c0 + 8 * lane < chunk) {
      // LSB-first: bit c % 8 of byte c / 8 marks column c
      uint8_t* bits = static_cast<uint8_t*>(out.idx) +
                      (static_cast<size_t>(i) * geo.n_chunks + ci) * (chunk / 8);
      bits[c0 / 8 + lane] = static_cast<uint8_t>(sel_mask >> (8 * lane));
    }
    eq_seen += __popc(eq_mask);
    sel_seen += __popc(sel_mask);
  }
  __syncwarp();

  if (lane == 0) {
    out.scales[static_cast<size_t>(i) * geo.n_chunks + ci] = scale;
  }
  // The wire: k values (and positions) per chunk.
  const size_t krow = (static_cast<size_t>(i) * geo.n_chunks + ci) * k;
  for (int e = lane; e < k; e += 32) {
    const int c = sm.spos[e];
    const float p = sm.trow[c];
    int slot = e;  // BITMAP: ascending position
    if (ENC != kBitmap) {
      const unsigned mb = mag_bits(p);
      slot = 0;
      for (int f = 0; f < k; ++f) {
        const unsigned fb = mag_bits(sm.trow[sm.spos[f]]);
        slot += (fb > mb) || (fb == mb && f < e);
      }
    }
    // q is an integer in [-127, 127]: the cast is exact
    out.q[krow + slot] = static_cast<int8_t>(__float2int_rn(quantize(p, safe)));
    if (ENC == kPos16) static_cast<int16_t*>(out.idx)[krow + slot] = static_cast<int16_t>(c);
    if (ENC == kPos32) static_cast<int32_t*>(out.idx)[krow + slot] = c;
  }
  // The sender's own recon' and res' over every column of the chunk.
  for (int c = lane; c < chunk; c += 32) {
    const float p = sm.trow[c];
    const bool sel = (sm.smask[c / 32] >> (c % 32)) & 1u;
    const float dq = sel ? __fadd_rn(0.f, __fmul_rn(quantize(p, safe), scale)) : 0.f;
    const float base = DC ? recon[row + c] : 0.f;
    out.new_recon[row + c] = __fadd_rn(base, dq);
    out.new_res[row + c] = EF ? __fsub_rn(p, dq) : res[row + c];
  }
  __syncwarp();  // the next stage reuses this warp's shared buffers
}

// This warp's (row, chunk) and shared buffers, or false past the end
// (the whole warp leaves: the kernels have no block-wide barrier).
__device__ bool warp_pair(const Geometry& geo, unsigned char* smem, int* i,
                          int* ci, Smem* sm) {
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32;
  const size_t pair = static_cast<size_t>(blockIdx.x) * warps + w;
  if (pair >= static_cast<size_t>(geo.n) * geo.n_chunks) return false;
  *i = static_cast<int>(pair / geo.n_chunks);
  *ci = static_cast<int>(pair % geo.n_chunks);
  unsigned char* base = smem + warp_bytes(geo.chunk, geo.topk) * w;
  sm->trow = reinterpret_cast<float*>(base);
  sm->spos = reinterpret_cast<int*>(sm->trow + geo.chunk);
  sm->smask = reinterpret_cast<unsigned*>(sm->spos + geo.topk);
  return true;
}

template <bool EF, bool DC, int ENC>
__global__ void __launch_bounds__(kMaxWarps * 32)
wire_stage_compact_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ recon,
                          const float* __restrict__ res, float alpha,
                          float* __restrict__ h, CompactOut out, Geometry geo) {
  extern __shared__ unsigned char smem[];
  int i, ci;
  Smem sm;
  if (!warp_pair(geo, smem, &i, &ci, &sm)) return;
  compact_stage<EF, DC, ENC>(Update{x, g, alpha}, recon, res, h, out, i, ci,
                             sm, geo);
}

// ---------------------------------------------------------------------------
// DSGT: a block a (row, chunk), both wires at once.

constexpr int kGtThreads = 128;
constexpr int kGtWarps = kGtThreads / 32;
constexpr int kTracker = 0, kParam = 1;  // the wires' indices

struct GtParams {
  const float* x;
  const float* t;
  const float* g;
  const float* gp;
  const float* recon[2];  // [kTracker], [kParam]
  const float* res[2];
  float alpha;
  float* h;
  float* t_half;
  CompactOut out[2];
  int chunk, n_chunks, k;
  int together;  // both payload rows fit: one sweep; else a wire a sweep
  int vec;       // every row 16-byte aligned: 16-byte loads and stores
};

// The DSGT kernel's shared memory, in 4-byte words: the payload rows of
// the wires a sweep takes (both, or one), a radix histogram for each
// wire's select warp, (positions) the survivors' positions and |payload|
// bits, the warps' {above, at} counts and row maxes, and each wire's
// threshold and tie count. ../ops.py compact_gt_plan mirrors it.
struct GtLayout {
  size_t hist, spos, skey, counts, maxes, sel, total;
  __host__ __device__ GtLayout(int chunk, int k, int enc, bool together) {
    const size_t rows = together ? 2 : 1;
    const size_t kk = enc == kBitmap ? 0 : static_cast<size_t>(k);
    hist = rows * chunk;
    spos = hist + 2 * kRadixBins;
    skey = spos + rows * kk;
    counts = skey + rows * kk;
    maxes = counts + 2 * kGtWarps * 2;
    sel = maxes + 2 * kGtWarps;
    total = sel + 2 * 2;
  }
};

// 4 adjacent columns (nc of them at the chunk's ragged end, the rest
// zero): one 16-byte access where every row is aligned (then nc is 4).
__device__ __forceinline__ void load4(float v[4], const float* src, int nc,
                                      bool vec) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = s < nc ? src[s] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* dst, const float v[4], int nc,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < nc) dst[s] = v[s];
    }
  }
}

template <bool EF, bool DC, int ENC>
__global__ void __launch_bounds__(kGtThreads)
wire_stage_gt_compact_kernel(const GtParams p) {
  extern __shared__ float gsm[];
  const int chunk = p.chunk, k = p.k;
  const GtLayout lay(chunk, k, ENC, p.together);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // block b owns row b / n_chunks, chunk b % n_chunks: its columns start
  // at b * chunk of the (n, t) buffers, its k values at b * k
  const size_t pair = blockIdx.x;
  const size_t row = pair * chunk, krow = pair * k;
  const int n_items = (chunk + 3) / 4;  // 4 adjacent columns an item
  int* counts = reinterpret_cast<int*>(gsm + lay.counts);  // [wire][warp][above, at]
  float* maxes = gsm + lay.maxes;                           // [wire][warp]
  unsigned* sel = reinterpret_cast<unsigned*>(gsm + lay.sel);  // [wire][thr, ties]

  for (int sweep = 0; sweep < (p.together ? 1 : 2); ++sweep) {
    // bit w: wire w runs in this sweep (one at a time: the tracker first)
    const unsigned on = p.together ? 3u : 1u << sweep;
    float* prow[2];  // each wire's payload row
#pragma unroll
    for (int w = 0; w < 2; ++w) prow[w] = gsm + (p.together ? w * chunk : 0);

    // 1. payloads: t_half once (and h), both wires' payloads into their
    // rows, the row maxes; every load of an item issued first
    float m[2] = {0.f, 0.f};
    for (int item = tid; item < n_items; item += kGtThreads) {
      const int c0 = 4 * item, nc = min(4, chunk - c0);
      const size_t o = row + c0;
      float tv[4], gv[4], gpv[4], xv[4] = {0.f, 0.f, 0.f, 0.f}, base[2][4], rs[2][4];
      load4(tv, p.t + o, nc, p.vec);
      load4(gv, p.g + o, nc, p.vec);
      load4(gpv, p.gp + o, nc, p.vec);
      if (on & 2u) load4(xv, p.x + o, nc, p.vec);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
#pragma unroll
        for (int s = 0; s < 4; ++s) base[w][s] = rs[w][s] = 0.f;
        if (on >> w & 1u) {
          if (DC) load4(base[w], p.recon[w] + o, nc, p.vec);
          if (EF) load4(rs[w], p.res[w] + o, nc, p.vec);
        }
      }
      float src[2][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        src[kTracker][s] = __fsub_rn(__fadd_rn(tv[s], gv[s]), gpv[s]);
        src[kParam][s] = __fsub_rn(xv[s], __fmul_rn(p.alpha, src[kTracker][s]));
      }
      if (on & 1u) store4(p.t_half + o, src[kTracker], nc, p.vec);
      if (on & 2u) store4(p.h + o, src[kParam], nc, p.vec);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (!(on >> w & 1u)) continue;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < nc) {
            const float pl = payload_elem<EF>(src[w][s], base[w][s], rs[w][s]);
            prow[w][c0 + s] = pl;
            m[w] = fmaxf(m[w], fabsf(pl));
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m[w] = fmaxf(m[w], __shfl_xor_sync(kFullMask, m[w], off));
      }
      if (lane == 0) maxes[w * kGtWarps + warp] = m[w];
    }
    __syncthreads();

    // 2. the thresholds: warp w selects on wire w, the two at once
    if (warp < 2 && (on >> warp & 1u)) {
      const float* pr = gsm + (p.together ? warp * chunk : 0);
      int ties;
      const unsigned thr = radix_select([pr](int c) { return mag_bits(pr[c]); },
                                        chunk, k,
                                        reinterpret_cast<int*>(gsm + lay.hist) +
                                            warp * kRadixBins,
                                        &ties);
      if (lane == 0) {
        sel[2 * warp] = thr;
        sel[2 * warp + 1] = static_cast<unsigned>(ties);
      }
    }
    __syncthreads();

    float scale[2], safe[2];
    unsigned thr[2];
    int ties[2];
    int above0[2] = {0, 0}, at0[2] = {0, 0};  // counts of the earlier steps
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float mw = 0.f;
      for (int v = 0; v < kGtWarps; ++v) mw = fmaxf(mw, maxes[w * kGtWarps + v]);
      scale[w] = __fdiv_rn(mw, 127.f);
      safe[w] = scale[w] > 0.f ? scale[w] : 1.f;
      thr[w] = sel[2 * w];
      ties[w] = static_cast<int>(sel[2 * w + 1]);
      if (tid == 0 && (on >> w & 1u)) p.out[w].scales[pair] = scale[w];
    }

    // 3. the tie fill and the outputs, 128 items a step: each column's
    // counts of the columns above and at the threshold before it, from a
    // warp scan and the warps' totals
    for (int it0 = 0; it0 < n_items; it0 += kGtThreads) {
      const int item = it0 + tid;
      const int c0 = 4 * item;
      const int nc = item < n_items ? min(4, chunk - c0) : 0;
      unsigned above[2], at[2];  // bit s: column c0 + s above / at the threshold
      int above_x[2], at_x[2];   // such columns before c0
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        above[w] = at[w] = 0u;
        if (on >> w & 1u) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            if (s < nc) {
              const unsigned key = mag_bits(prow[w][c0 + s]);
              above[w] |= static_cast<unsigned>(key > thr[w]) << s;
              at[w] |= static_cast<unsigned>(key == thr[w]) << s;
            }
          }
        }
        const int na = __popc(above[w]), ne = __popc(at[w]);
        int ia = na, ie = ne;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int va = __shfl_up_sync(kFullMask, ia, off);
          const int ve = __shfl_up_sync(kFullMask, ie, off);
          if (lane >= off) {
            ia += va;
            ie += ve;
          }
        }
        if (lane == 31) {
          counts[(w * kGtWarps + warp) * 2] = ia;
          counts[(w * kGtWarps + warp) * 2 + 1] = ie;
        }
        above_x[w] = ia - na;
        at_x[w] = ie - ne;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        int sum_a = 0, sum_e = 0;
        for (int v = 0; v < kGtWarps; ++v) {
          const int a = counts[(w * kGtWarps + v) * 2];
          const int e = counts[(w * kGtWarps + v) * 2 + 1];
          if (v < warp) {
            above_x[w] += a;
            at_x[w] += e;
          }
          sum_a += a;
          sum_e += e;
        }
        above_x[w] += above0[w];
        at_x[w] += at0[w];
        above0[w] += sum_a;
        at0[w] += sum_e;
        if (!(on >> w & 1u)) continue;  // block-uniform
        const CompactOut& out = p.out[w];
        float base[4] = {0.f, 0.f, 0.f, 0.f}, rs[4] = {0.f, 0.f, 0.f, 0.f};
        if (nc > 0) {
          if (DC) load4(base, p.recon[w] + row + c0, nc, p.vec);
          if (!EF) load4(rs, p.res[w] + row + c0, nc, p.vec);
        }
        float nr[4], nres[4];
        unsigned kept = 0u;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float pl = s < nc ? prow[w][c0 + s] : 0.f;
          const unsigned lower = (1u << s) - 1u;
          const int at_before = at_x[w] + __popc(at[w] & lower);
          const bool keep = (above[w] >> s & 1u) ||
                            ((at[w] >> s & 1u) && at_before < ties[w]);
          float dq = 0.f;
          if (keep) {
            const float q = quantize(pl, safe[w]);
            dq = __fadd_rn(0.f, __fmul_rn(q, scale[w]));
            kept |= 1u << s;
            // the column's slot among the survivors in ascending order
            const int slot = above_x[w] + __popc(above[w] & lower) +
                             min(at_before, ties[w]);
            if (ENC == kBitmap) {
              // q is an integer in [-127, 127]: the cast is exact
              out.q[krow + slot] = static_cast<int8_t>(__float2int_rn(q));
            } else {
              const size_t r = p.together ? w : 0;
              reinterpret_cast<int*>(gsm + lay.spos)[r * k + slot] = c0 + s;
              reinterpret_cast<unsigned*>(gsm + lay.skey)[r * k + slot] = mag_bits(pl);
            }
          }
          nr[s] = __fadd_rn(base[s], dq);
          nres[s] = EF ? __fsub_rn(pl, dq) : rs[s];
        }
        if (nc > 0) {
          store4(out.new_recon + row + c0, nr, nc, p.vec);
          store4(out.new_res + row + c0, nres, nc, p.vec);
        }
        if (ENC == kBitmap) {
          // LSB-first: bit c % 8 of byte c / 8 marks column c; a byte is
          // the items of a lane pair
          const unsigned hi = __shfl_down_sync(kFullMask, kept, 1);
          if (lane % 2 == 0 && nc > 0) {
            static_cast<uint8_t*>(out.idx)[pair * (chunk / 8) + item / 2] =
                static_cast<uint8_t>(kept | hi << 4);
          }
        }
      }
      __syncthreads();  // the next step rewrites the counts
    }

    // 4. (positions) the wire order, descending |payload| with ties by
    // index: a survivor's rank is #{|p_f| > |p_e|} + #{f < e : |p_f| =
    // |p_e|} over the k survivors (listed in ascending position), a
    // thread a survivor
    if (ENC != kBitmap) {
      for (int e2 = tid; e2 < 2 * k; e2 += kGtThreads) {
        const int w = e2 < k ? 0 : 1, e = e2 - w * k;
        if (!(on >> w & 1u)) continue;
        const size_t r = p.together ? w : 0;
        const int* spos = reinterpret_cast<const int*>(gsm + lay.spos) + r * k;
        const unsigned* skey = reinterpret_cast<const unsigned*>(gsm + lay.skey) + r * k;
        const unsigned key = skey[e];
        int rank = 0;
        for (int f = 0; f < k; ++f) {
          const unsigned kf = skey[f];
          rank += (kf > key) || (kf == key && f < e);
        }
        const int c = spos[e];
        const CompactOut& out = w ? p.out[kParam] : p.out[kTracker];
        const float q = quantize(gsm[r * chunk + c], w ? safe[kParam] : safe[kTracker]);
        out.q[krow + rank] = static_cast<int8_t>(__float2int_rn(q));
        if (ENC == kPos16) static_cast<int16_t*>(out.idx)[krow + rank] = static_cast<int16_t>(c);
        if (ENC == kPos32) static_cast<int32_t*>(out.idx)[krow + rank] = c;
      }
    }
    __syncthreads();  // the next sweep reuses the rows and lists
  }
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const Geometry& geo, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_bytes(geo.chunk, geo.topk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int warps = warps_per_block(geo.chunk, geo.topk);
  const size_t pairs = static_cast<size_t>(geo.n) * geo.n_chunks;
  const unsigned blocks = static_cast<unsigned>((pairs + warps - 1) / warps);
  kernel<<<blocks, warps * 32, smem, stream>>>(args..., geo);
  return cudaGetLastError();
}

// The 12 (ef, dc, encoding) instantiations of one kernel template,
// indexed (ef << 1 | dc) * 3 + encoding.
#define ENC_ROW(K, EF, DC) K<EF, DC, kPos16>, K<EF, DC, kPos32>, K<EF, DC, kBitmap>
#define FLAG_TABLE(K)                                          \
  { ENC_ROW(K, false, false), ENC_ROW(K, false, true),         \
    ENC_ROW(K, true, false), ENC_ROW(K, true, true) }

int flag_index(int ef, int dc, int encoding) {
  return ((ef ? 2 : 0) | (dc ? 1 : 0)) * 3 + encoding;
}

size_t gt_smem_bytes(int chunk, int k, int encoding, int together) {
  return sizeof(float) * GtLayout(chunk, k, encoding, together != 0).total;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (what the wrapper checks against
// the 227 KB per-block limit before launching): the DSGD stage's, and the
// DSGT stage's in the layout `together` names.
size_t wire_stage_compact_smem_bytes(int chunk, int topk) {
  return smem_bytes(chunk, topk);
}

size_t wire_stage_gt_compact_smem_bytes(int chunk, int topk, int encoding,
                                        int together) {
  return gt_smem_bytes(chunk, topk, encoding, together);
}

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns cudaGetLastError().
// topk: 1 <= topk < chunk columns kept per (row, chunk). encoding: 0
// int16 positions, 1 int32 positions, 2 the presence bitmap (idx is then
// uint8 (n, n_chunks * chunk / 8)).
int wire_stage_compact_launch(const float* x, const float* g,
                              const float* recon, const float* res,
                              float alpha, float* h, int8_t* q, void* idx,
                              float* scales, float* new_recon, float* new_res,
                              int n, int t, int chunk, int topk, int ef, int dc,
                              int encoding, void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      float, float*, CompactOut, Geometry);
  static const Fn table[12] = FLAG_TABLE(wire_stage_compact_kernel);
  return launch(table[flag_index(ef, dc, encoding)],
                Geometry{n, t, chunk, n, t / chunk, topk},
                static_cast<cudaStream_t>(stream), x, g, recon, res, alpha, h,
                CompactOut{q, idx, scales, new_recon, new_res});
}

// The DSGT stage. together: both wires' payload rows in one sweep (1) or
// one wire after the other (0), as ../ops.py compact_gt_plan chose it.
int wire_stage_gt_compact_launch(
    const float* x, const float* t, const float* g, const float* gp,
    const float* recon_x, const float* res_x, const float* recon_t,
    const float* res_t, float alpha, float* h, float* t_half, int8_t* q_x,
    void* idx_x, float* scales_x, float* new_recon_x, float* new_res_x,
    int8_t* q_t, void* idx_t, float* scales_t, float* new_recon_t,
    float* new_res_t, int n, int tot, int chunk, int topk, int ef, int dc,
    int encoding, int together, void* stream) {
  GtParams p = {};
  p.x = x;
  p.t = t;
  p.g = g;
  p.gp = gp;
  p.recon[kTracker] = recon_t;
  p.res[kTracker] = res_t;
  p.recon[kParam] = recon_x;
  p.res[kParam] = res_x;
  p.alpha = alpha;
  p.h = h;
  p.t_half = t_half;
  p.out[kTracker] = CompactOut{q_t, idx_t, scales_t, new_recon_t, new_res_t};
  p.out[kParam] = CompactOut{q_x, idx_x, scales_x, new_recon_x, new_res_x};
  p.chunk = chunk;
  p.n_chunks = tot / chunk;
  p.k = topk;
  p.together = together;
  bool vec = tot % 4 == 0 && chunk % 4 == 0;
  const void* rows[] = {x, t, g, gp, recon_x, res_x, recon_t, res_t, h, t_half,
                        new_recon_x, new_res_x, new_recon_t, new_res_t};
  for (const void* r : rows) vec = vec && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  p.vec = vec;
  using Fn = void (*)(GtParams);
  static const Fn table[12] = FLAG_TABLE(wire_stage_gt_compact_kernel);
  const Fn fn = table[flag_index(ef, dc, encoding)];
  const size_t smem = gt_smem_bytes(chunk, topk, encoding, together);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(static_cast<size_t>(n) * p.n_chunks);
  fn<<<blocks, kGtThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
