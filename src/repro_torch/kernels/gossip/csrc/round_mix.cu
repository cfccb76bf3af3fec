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
// past about 130-170 nodes no longer fits. Held within fp32 summation
// order to the PyTorch twin (../ref.py round_mix_ref); it sums in the
// one-pass kernel's order, so where both run it gives the same bits.
//
// Bound: HBM bytes. Each wire reads nbr and self and writes mixed, 12 B
// an element, plus W_off and w_self; the mix is 2 operations a nonzero
// of W_off an element, far under the fp32 peak for a graph's sparse W
// (a dense W at n = 512 is bound by its operations).
//
// Design: two kernels a launch, on one stream.
//   * list_kernel reads W_off once, a warp a row: a ballot across each 32
//     columns in ascending j writes the row's nonzeros -- the column
//     (times the strip width: the staged row's offset) and the weight --
//     and their count into scratch the wrapper allocates (ELL, padded to
//     n a row). The lists come from the W handed in, every
//     launch (a dynamic round hands a new W every round; no host sync).
//   * strip_kernel: a persistent block, one an SM (32 warps), walks the
//     (wire, strip) tiles, a strip `cols` columns. For each it copies
//     nbr[:, strip] of all n rows into shared memory once by cp.async (16
//     bytes where every row is 16-byte aligned, 4 otherwise), so each nbr
//     element leaves HBM once, in 128 B row segments where n allows (HBM
//     serves narrower scattered segments at a fraction of its rate). Its
//     warps then take a row at a time, a lane a column: the row's list
//     entries (only its count of them) and self terms come by cp.async
//     into the warp's ring kDepth rows ahead, so the row loop streams
//     self in and mixed out without waiting on each row's loads; each
//     term is a broadcast read of (j, weight) and a conflict-free read of
//     staged row j. The plan (../ops.py mix_plan) takes the widest strip
//     that fits, narrower as n grows. DSGT's two wires are two tiles of a
//     strip: both wires side by side would halve each wire's segment.
//   * band_kernel, where even a 4-column strip of all n rows cannot fit
//     (n over ~8,150): a block takes a band of kBandRows rows and a
//     strip, walks j in ascending windows of `window` staged rows, and
//     keeps each row's sum and its place in its list in registers between
//     windows.
//   * Each output sums fmaf over its row's nonzeros in ascending j, then
//     adds w_self * self, each rounded once (the gossip build passes
//     -fmad=false). A zero weight adds exact zeros on finite inputs, so
//     leaving W's zeros out gives the one-pass kernel's bits (it skips
//     W_off's zero 4 x 4 blocks and adds the zeros inside the others).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 256;  // the listing: a warp a row
// a warp's ring of row copies on the strip path: kDepth stages of 32 list
// entries (int2) and 32 self terms (../ops.py _MIX_RING_BYTES)
constexpr int kDepth = 2;
constexpr int kStageWords = 96;
constexpr int kRingWords = kWarps * kDepth * kStageWords;
constexpr int kBandRowsPerWarp = 8;
constexpr int kBandRows = kWarps * kBandRowsPerWarp;  // ../ops.py _MIX_BAND_ROWS
constexpr unsigned kFullMask = 0xffffffffu;

struct MixParams {
  const float* nbr[2];
  const float* self[2];
  float* mixed[2];
  const int2* list;   // (n, n): row i's nonzeros (j * cols, weight bits), ascending j
  const int* counts;  // (n,): each row's count
  const float* w_self;
  int n, t, wires;
  int cols;    // columns a strip (a multiple of 4, at most 32: a lane each)
  int window;  // rows staged at once: n on the strip path
};

__global__ void __launch_bounds__(kListThreads)
list_kernel(const float* __restrict__ w_off, int n, int stride, int2* __restrict__ list,
            int* __restrict__ counts) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (kListThreads / 32) + threadIdx.x / 32;
  if (i >= n) return;  // a whole warp
  const float* row = w_off + static_cast<size_t>(i) * n;
  int2* out = list + static_cast<size_t>(i) * n;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const float w = j < n ? row[j] : 0.f;
    const bool nz = w != 0.f;
    const unsigned ballot = __ballot_sync(kFullMask, nz);
    if (nz) {
      out[count + __popc(ballot & ((1u << lane) - 1u))] =
          make_int2(j * stride, __float_as_int(w));
    }
    count += __popc(ballot);
  }
  if (lane == 0) counts[i] = count;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// 8 bytes, or (valid false) 8 zero bytes and no read
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of rows j0 .. j0 + rows - 1 of the strip of `cols`
// columns at col0 of `nbr` into s (row r at r * cols). Columns past t are
// not copied: no lane stores from them. Every thread of the block calls it.
template <bool VEC>
__device__ __forceinline__ void stage(const float* nbr, float* s, int j0, int rows,
                                      int cols, size_t t, size_t col0) {
  constexpr int kPiece = VEC ? 4 : 1;  // floats a copy
  const int per_row = cols / kPiece;
  const int c = kPiece * (threadIdx.x % per_row), step = kThreads / per_row;
  if (threadIdx.x >= step * per_row || col0 + c >= t) return;
  const float* src = nbr + col0 + c;
  for (int r = threadIdx.x / per_row; r < rows; r += step) {
    if (VEC) {
      cp_async16(s + r * cols + c, src + static_cast<size_t>(j0 + r) * t);
    } else {
      cp_async4(s + r * cols + c, src + static_cast<size_t>(j0 + r) * t);
    }
  }
}

// Sums the first m entries of a warp's listed terms (16-byte aligned),
// ascending, into acc: two (offset of staged row j, weight) pairs a
// broadcast read, then a read of staged row j each.
__device__ __forceinline__ float sum_terms(const int2* ent, int m, const float* sl, float acc) {
  const int4* pairs = reinterpret_cast<const int4*>(ent);
  int e = 0;
  for (; e + 4 <= m; e += 4) {
    const int4 ab = pairs[e / 2], cd = pairs[e / 2 + 1];
    acc = fmaf(__int_as_float(ab.y), sl[ab.x], acc);
    acc = fmaf(__int_as_float(ab.w), sl[ab.z], acc);
    acc = fmaf(__int_as_float(cd.y), sl[cd.x], acc);
    acc = fmaf(__int_as_float(cd.w), sl[cd.z], acc);
  }
  for (; e < m; ++e) {
    const int2 a = ent[e];
    acc = fmaf(__int_as_float(a.y), sl[a.x], acc);
  }
  return acc;
}

// The strip path: a block (one an SM) stages a wire's strip of all n rows
// once, then its warps take a row at a time, each row's list entries and
// self terms copied kDepth rows ahead into the warp's ring.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1) strip_kernel(const MixParams p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n = p.n, cols = p.cols;
  float* ring = smem + warp * kDepth * kStageWords;
  int* cnt_s = reinterpret_cast<int*>(smem + kRingWords);
  float* ws_s = smem + kRingWords + n;
  float* s = smem + kRingWords + ((2 * n + 3) & ~3);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    cnt_s[k] = p.counts[k];
    ws_s[k] = p.w_self[k];
  }
  const size_t t = p.t;
  const bool active = lane < cols;
  const float* sl = s + (active ? lane : 0);
  const int strips = (p.t + cols - 1) / cols;
  for (int tile = blockIdx.x; tile < strips * p.wires; tile += gridDim.x) {
    const bool w1 = tile % p.wires == 1;
    const size_t col0 = static_cast<size_t>(tile / p.wires) * cols;
    const size_t col = col0 + lane;
    const bool live = active && col < t;
    const float* self = w1 ? p.self[1] : p.self[0];
    float* mixed = w1 ? p.mixed[1] : p.mixed[0];
    // row i's list entries and self term into a ring stage
    auto fetch = [&](int i, float* st) {
      const int2* lst = p.list + static_cast<size_t>(i) * n;
      cp_async8_zfill(st + 2 * lane, lst + (lane < n ? lane : 0), lane < cnt_s[i]);
      if (live) cp_async4(st + 64 + lane, self + static_cast<size_t>(i) * t + col);
    };
    __syncthreads();  // the last strip's reads are done; the counts are in
    stage<VEC>(w1 ? p.nbr[1] : p.nbr[0], s, 0, n, cols, t, col0);
    for (int d = 0; d < kDepth; ++d) {
      if (warp + d * kWarps < n) fetch(warp + d * kWarps, ring + d * kStageWords);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    float* out = mixed + static_cast<size_t>(warp) * t + col;
    const size_t out_step = static_cast<size_t>(kWarps) * t;
    for (int k = 0, i = warp; i < n; ++k, i += kWarps, out += out_step) {
      float* st = ring + (k % kDepth) * kStageWords;
      cp_wait<kDepth - 1>();  // this row's copies (the later rows' may fly)
      __syncwarp();
      const int cnt = cnt_s[i];
      int2* ent = reinterpret_cast<int2*>(st);
      float acc = sum_terms(ent, cnt < 32 ? cnt : 32, sl, 0.f);
      for (int base = 32; base < cnt; base += 32) {  // rows of over 32 neighbours
        const int2 a = base + lane < cnt
                           ? __ldg(p.list + static_cast<size_t>(i) * n + base + lane)
                           : make_int2(0, 0);
        __syncwarp();
        ent[lane] = a;
        __syncwarp();
        acc = sum_terms(ent, cnt - base < 32 ? cnt - base : 32, sl, acc);
      }
      if (live) *out = __fadd_rn(acc, __fmul_rn(ws_s[i], st[64 + lane]));
      __syncwarp();  // the stage's reads are done
      if (i + kDepth * kWarps < n) fetch(i + kDepth * kWarps, st);
      cp_commit();
    }
  }
}

// The band path: a block takes a band of kBandRows rows and a wire's
// strip, walks j in ascending windows of `window` staged rows, and keeps
// each row's sum and its place in its list in registers between windows.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1) band_kernel(const MixParams p) {
  extern __shared__ __align__(16) float s[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n = p.n, cols = p.cols;
  const size_t t = p.t;
  const bool active = lane < cols;
  const float* sl = s + (active ? lane : 0);
  const int strips = (p.t + cols - 1) / cols;
  const int bands = (n + kBandRows - 1) / kBandRows;
  // band fastest: the blocks at work share their strips' rows through L2
  for (int tile = blockIdx.x; tile < bands * strips * p.wires; tile += gridDim.x) {
    const int row0 = (tile % bands) * kBandRows + warp;
    const bool w1 = tile / bands % p.wires == 1;
    const size_t col0 = static_cast<size_t>(tile / bands / p.wires) * cols;
    float acc[kBandRowsPerWarp];
    int cur[kBandRowsPerWarp], cnt[kBandRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kBandRowsPerWarp; ++k) {
      const int i = row0 + k * kWarps;
      acc[k] = 0.f;
      cur[k] = 0;
      cnt[k] = i < n ? p.counts[i] : 0;
    }
    for (int j0 = 0; j0 < n; j0 += p.window) {
      const int j1 = j0 + p.window < n ? j0 + p.window : n;
      __syncthreads();  // the last window's reads are done
      stage<VEC>(w1 ? p.nbr[1] : p.nbr[0], s, j0, j1 - j0, cols, t, col0);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBandRowsPerWarp; ++k) {
        const int2* lst = p.list + static_cast<size_t>(row0 + k * kWarps) * n;
        for (; cur[k] < cnt[k]; ++cur[k]) {
          const int2 a = __ldg(lst + cur[k]);
          if (a.x >= j1 * cols) break;
          acc[k] = fmaf(__int_as_float(a.y), sl[a.x - j0 * cols], acc[k]);
        }
      }
    }
    const size_t col = col0 + lane;
    if (!active || col >= t) continue;
    const float* self = w1 ? p.self[1] : p.self[0];
    float* mixed = w1 ? p.mixed[1] : p.mixed[0];
#pragma unroll
    for (int k = 0; k < kBandRowsPerWarp; ++k) {
      const int i = row0 + k * kWarps;
      if (i >= n) break;
      const size_t at = static_cast<size_t>(i) * t + col;
      mixed[at] = __fadd_rn(acc[k], __fmul_rn(p.w_self[i], self[at]));
    }
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

using MixFn = void (*)(MixParams);

MixFn mix_fn(bool band, bool vec) {
  return band ? (vec ? band_kernel<true> : band_kernel<false>)
              : (vec ? strip_kernel<true> : strip_kernel<false>);
}

// The band path stages `window` rows of a strip; the strip path all n
// rows beside the warps' rings and each row's count and w_self.
size_t smem_bytes(int n, int window, int cols) {
  const size_t words = window < n ? static_cast<size_t>(window) * cols
                                  : kRingWords + ((2 * n + 3) & ~3) +
                                        static_cast<size_t>(n) * cols;
  return words * sizeof(float);
}

cudaError_t prepare(MixFn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The mix kernels' shared memory a block (../ops.py mix_plan holds its
// plan against this).
size_t round_mix_smem_bytes(int n, int window, int cols) {
  return smem_bytes(n, window, cols);
}

// Blocks of the mix kernel (the band kernel's where window < n) an SM
// holds at this layout, or minus a CUDA error.
int round_mix_max_active(int n, int cols, int window, int vec) {
  const MixFn fn = mix_fn(window < n, vec != 0);
  const size_t smem = smem_bytes(n, window, cols);
  cudaError_t err = prepare(fn, smem);
  int active = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, fn, kThreads, smem);
  }
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

// Whether the 16-byte copies serve these buffers: t a multiple of 4 and
// every neighbour view 16-byte aligned (self and mixed are read and
// written a float a lane).
int round_mix_vec(const float* nbr0, const float* nbr1, int t) {
  return t % 4 == 0 && aligned16(nbr0) && aligned16(nbr1);
}

// mixed_w = W_off @ nbr_w + w_self * self_w for the `wires` (1 or 2) wires
// given (the second wire's pointers null for one), each (n, t) fp32
// row-major; w_off (n, n), w_self (n,). `list` (n * n int2) and `counts`
// (n int) are scratch the listing fills. The mix runs `grid` persistent
// blocks on strips of `cols` columns, `window` rows staged at once
// (../ops.py mix_plan). Launches both kernels on `stream` and returns the
// first error.
int round_mix_launch(const float* w_off, const float* w_self,
                     const float* nbr0, const float* self0, float* mixed0,
                     const float* nbr1, const float* self1, float* mixed1,
                     void* list, void* counts, int n, int t, int wires, int cols,
                     int window, int grid, void* stream) {
  MixParams p = {};
  p.nbr[0] = nbr0;
  p.nbr[1] = nbr1;
  p.self[0] = self0;
  p.self[1] = self1;
  p.mixed[0] = mixed0;
  p.mixed[1] = mixed1;
  p.list = static_cast<const int2*>(list);
  p.counts = static_cast<const int*>(counts);
  p.w_self = w_self;
  p.n = n;
  p.t = t;
  p.wires = wires;
  p.cols = cols;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_a_block = kListThreads / 32;
  list_kernel<<<(n + rows_a_block - 1) / rows_a_block, kListThreads, 0, s>>>(
      w_off, n, cols, static_cast<int2*>(list), static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const MixFn fn = mix_fn(window < n, round_mix_vec(nbr0, nbr1, t) != 0);
  const size_t smem = smem_bytes(n, window, cols);
  err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
