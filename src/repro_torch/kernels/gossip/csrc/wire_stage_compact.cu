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
// element. The selection costs 31 ballot passes of the threshold search
// per (row, chunk) and an O(k^2) rank count, both in shared memory.
//
// Design (simple and right first; it reuses what wire_stage.cu proved):
// one warp owns one (row, chunk), the payload row in a per-warp shared
// buffer (quantize.cuh's payload_row). Selection: the k-th largest
// |payload| counted with multiplicity (topk_threshold, a bit-pattern
// search) is the threshold; every column above it is kept, and columns
// equal to it are kept by ascending index until k are filled (ballot +
// popc prefix), which is jax.lax.top_k's tie rule. The same pass lists
// the survivors' positions in ascending order in shared memory and keeps
// the per-32-column selection masks. The wire order of top_k (descending
// |payload|, ties by index) is each survivor's rank among the survivors:
// #{|p_j| > |p_i|} + #{j < i : |p_j| = |p_i|} -- a column that outranks a
// survivor is itself a survivor, so counting over the k survivors is
// enough. scale = max|payload| / 127 (the largest column always
// survives); dq is 0.0 + q * scale on survivors and +0.0 elsewhere, as
// the reference's scatter into zeros gives it.

#include "quantize.cuh"

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

template <bool EF, bool DC, int ENC>
__global__ void __launch_bounds__(kMaxWarps * 32)
wire_stage_gt_compact_kernel(
    const float* __restrict__ x, const float* __restrict__ t,
    const float* __restrict__ g, const float* __restrict__ gp,
    const float* __restrict__ recon_x, const float* __restrict__ res_x,
    const float* __restrict__ recon_t, const float* __restrict__ res_t,
    float alpha, float* __restrict__ h, float* __restrict__ t_half,
    CompactOut out_x, CompactOut out_t, Geometry geo) {
  extern __shared__ unsigned char smem[];
  int i, ci;
  Smem sm;
  if (!warp_pair(geo, smem, &i, &ci, &sm)) return;
  const TrackerHalf th{t, g, gp};
  compact_stage<EF, DC, ENC>(th, recon_t, res_t, t_half, out_t, i, ci, sm,
                             geo);
  compact_stage<EF, DC, ENC>(TrackedUpdate{x, th, alpha}, recon_x, res_x, h,
                             out_x, i, ci, sm, geo);
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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (what the wrapper checks against
// the 227 KB per-block limit before launching).
size_t wire_stage_compact_smem_bytes(int chunk, int topk) {
  return smem_bytes(chunk, topk);
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

int wire_stage_gt_compact_launch(
    const float* x, const float* t, const float* g, const float* gp,
    const float* recon_x, const float* res_x, const float* recon_t,
    const float* res_t, float alpha, float* h, float* t_half, int8_t* q_x,
    void* idx_x, float* scales_x, float* new_recon_x, float* new_res_x,
    int8_t* q_t, void* idx_t, float* scales_t, float* new_recon_t,
    float* new_res_t, int n, int tot, int chunk, int topk, int ef, int dc,
    int encoding, void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      const float*, const float*, const float*, const float*,
                      float, float*, float*, CompactOut, CompactOut, Geometry);
  static const Fn table[12] = FLAG_TABLE(wire_stage_gt_compact_kernel);
  return launch(table[flag_index(ef, dc, encoding)],
                Geometry{n, tot, chunk, n, tot / chunk, topk},
                static_cast<cudaStream_t>(stream), x, t, g, gp, recon_x, res_x,
                recon_t, res_t, alpha, h, t_half,
                CompactOut{q_x, idx_x, scales_x, new_recon_x, new_res_x},
                CompactOut{q_t, idx_t, scales_t, new_recon_t, new_res_t});
}

}  // extern "C"
