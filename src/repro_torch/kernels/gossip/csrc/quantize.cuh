// The quantize-with-error-feedback stage shared by the round kernels and
// the gossip stage (fused_round_cluster.cu, through the element helpers)
// and the wire-stage kernels (wire_stage.cu, wire_stage_compact.cu): the
// per-tile `_quantize_ef` of src/repro/kernels/gossip/gossip.py:116,
// with the optional top-k mask of `_topk_mask` (gossip.py:103).
//
// One warp owns one (row, chunk). Lane l holds columns l, l + 32, ... of
// the chunk in a shared-memory row buffer and only ever touches those,
// so the row buffer needs no synchronization; the row max and the top-k
// counts are warp-wide (shuffles, ballots).
//
// The top-k mask is a template flag (TOPK), so the dense kernels carry
// none of its code. Rounding matches the PyTorch twins in ../ref.py
// exactly: explicitly rounded intrinsics (the build also passes
// -fmad=false), IEEE division, rintf (half to even), scale = max / 127
// before safe = scale > 0 ? scale : 1, and masked columns become +0.0.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gossip {

constexpr unsigned kFullMask = 0xffffffffu;

struct Geometry {
  int n, t, chunk, n_pad, n_chunks;
  int topk;  // columns kept per (row, chunk) when a kernel has TOPK on
};

// h = x - alpha * g (the DSGD local update, and DSGT's parameter step).
struct Update {
  const float* __restrict__ x;
  const float* __restrict__ g;
  float alpha;
  __device__ float operator()(size_t o) const {
    return __fsub_rn(x[o], __fmul_rn(alpha, g[o]));
  }
};

// t_half = (t + g) - g_prev (the DSGT tracker innovation).
struct TrackerHalf {
  const float* __restrict__ t;
  const float* __restrict__ g;
  const float* __restrict__ gp;
  __device__ float operator()(size_t o) const {
    return __fsub_rn(__fadd_rn(t[o], g[o]), gp[o]);
  }
};

// h = x - alpha * t_half (the DSGT parameter step against the tracker).
struct TrackedUpdate {
  const float* __restrict__ x;
  TrackerHalf th;
  float alpha;
  __device__ float operator()(size_t o) const {
    return __fsub_rn(x[o], __fmul_rn(alpha, th(o)));
  }
};

// What quantizing one (row, chunk) needs after its payload pass.
struct RowScale {
  float scale;  // max |payload| / 127: the wire's scale
  float safe;   // the divisor: scale, or 1 for an all-zero chunk
  float thr;    // top-k threshold on |payload|; 0 keeps every column
};

// The payload of one (row, chunk) -- src minus the difference-coding
// base, plus the EF residual -- into trow, and src itself into h_out
// when given. Returns the row's max |payload| on every lane (exact in any
// order, |payload| >= 0). Top-k never changes the max: the largest
// element is always kept.
// One payload element: src minus the difference-coding base (0 without
// difference coding), plus the EF residual.
template <bool EF>
__device__ __forceinline__ float payload_elem(float src, float base, float res) {
  float p = __fsub_rn(src, base);
  if (EF) p = __fadd_rn(p, res);
  return p;
}

// The row's scale and divisor from its max |payload|; thr left at 0.
__device__ __forceinline__ RowScale scale_of(float m) {
  const float scale = __fdiv_rn(m, 127.f);
  return RowScale{scale, scale > 0.f ? scale : 1.f, 0.f};
}

// q of one payload element: clip(rint(sel / safe), +-127) with sel the
// payload, or (TOPK) +0.0 below the top-k threshold.
template <bool TOPK>
__device__ __forceinline__ float quantize_elem(float p, const RowScale& rs) {
  const float sel = !TOPK || fabsf(p) >= rs.thr ? p : 0.f;
  return fminf(fmaxf(rintf(__fdiv_rn(sel, rs.safe)), -127.f), 127.f);
}

template <bool EF, bool DC, class Src>
__device__ float payload_row(const Src& src, const float* __restrict__ recon,
                             const float* __restrict__ res, size_t row,
                             int chunk, float* trow, float* __restrict__ h_out) {
  const int lane = threadIdx.x % 32;
  float m = 0.f;
  for (int c = lane; c < chunk; c += 32) {
    const float h = src(row + c);
    if (h_out != nullptr) h_out[row + c] = h;
    const float p =
        payload_elem<EF>(h, DC ? recon[row + c] : 0.f, EF ? res[row + c] : 0.f);
    trow[c] = p;
    m = fmaxf(m, fabsf(p));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  }
  return m;
}

// The k-th largest |payload| of the row counted with multiplicity, i.e.
// sort(|payload|)[chunk - k] as the reference computes it, found exactly
// by a 31-step search over the bit pattern of |payload|: for x >= 0 the
// float order is the order of the bits, so the threshold is the largest
// pattern v with #{|p| >= v} >= k. Each step counts with ballots over
// the whole warp (uniform trip count, so ragged chunks are safe).
__device__ inline float topk_threshold(const float* trow, int chunk, int k) {
  const int lane = threadIdx.x % 32;
  unsigned thr = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const unsigned cand = thr | (1u << bit);
    int count = 0;
    for (int c0 = 0; c0 < chunk; c0 += 32) {
      const int c = c0 + lane;
      const bool ge = c < chunk && __float_as_uint(fabsf(trow[c])) >= cand;
      count += __popc(__ballot_sync(kFullMask, ge));
    }
    if (count >= k) thr = cand;
  }
  return __uint_as_float(thr);
}

template <bool TOPK>
__device__ RowScale row_scale(float m, const float* trow, int chunk, int topk) {
  RowScale rs = scale_of(m);
  if (TOPK) rs.thr = topk_threshold(trow, chunk, topk);
  return rs;
}

// Quantize the row in trow: q = clip(rint(sel / safe), +-127) with sel
// the payload, or (TOPK) +0.0 below the top-k threshold; writes recon' =
// base + q * scale and res' = payload - q * scale (the FULL payload: EF
// absorbs what the mask dropped), then hands emit(c, q, recon') the rest.
template <bool EF, bool DC, bool TOPK, class Emit>
__device__ void quantize_row(const float* trow, const RowScale& rs,
                             const float* __restrict__ recon,
                             const float* __restrict__ res,
                             float* __restrict__ new_recon,
                             float* __restrict__ new_res, size_t row,
                             int chunk, Emit emit) {
  const int lane = threadIdx.x % 32;
  for (int c = lane; c < chunk; c += 32) {
    const float p = trow[c];
    const float q = quantize_elem<TOPK>(p, rs);
    const float dq = __fmul_rn(q, rs.scale);
    const float base = DC ? recon[row + c] : 0.f;
    const float nr = __fadd_rn(base, dq);
    new_recon[row + c] = nr;
    new_res[row + c] = EF ? __fsub_rn(p, dq) : res[row + c];
    emit(c, q, nr);
  }
}

}  // namespace gossip
