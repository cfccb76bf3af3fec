// Prefill (full-sequence) attention in bf16 on the tensor cores, for
// Hopper (sm_90a): a FlashAttention-2 design on mma.sync.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:113  flash_attention_bhsd
// (its pallas_call at :158) for bfloat16 inputs, which is what serving
// runs; float32 inputs go to flash_attention.cu. The function: causal
// and/or sliding-window self-attention (q and k positions both counted
// from 0; key j is live for query i when j <= i and j > i - window), GQA
// with un-repeated K/V (q-head h reads kv-head h / (H / K)), scores,
// softmax and accumulation in fp32 with scale hd^-0.5, the output in
// bf16; a row with no live key gives zeros. Held to the PyTorch twin in
// ../ref.py.
//
// Numbers: the one departure from the twin is P. The twin (like the
// Pallas kernel) keeps the probabilities in fp32; this kernel rounds P
// to bf16 to feed it to the tensor cores as the A operand of P·V, and
// sums the row's l from the same rounded P, so the output stays a convex
// combination of V rows. That costs at most 2^-9 max|v| an element,
// inside the bf16 tolerance 1.6e-2 (1 + |want|).
//
// Bound: operations. 4 hd flops per live (query, key) pair against 2 hd
// x 2 bytes of K/V per key; at S 4096 and hd 64 that is ~1,000 flops a
// byte, above the H100's ~295 bf16 flops per byte of HBM, so the bound is
// the dense bf16 tensor-core rate (989 TFLOP/s at 700 W). mma.sync
// reaches only part of it (wgmma is the full rate), and between the mma
// sit the shared-memory fragment reads and the softmax, so the design
// spends its effort on feeding more mma per fragment and fewer ALU
// instructions per score.
//
// Design (warp-specialised wgmma with TMA is the step after this one):
//   * Inputs stay in the model layout: q (B, Sq, H, hd), k/v (B, Sk, K,
//     hd); no repeated or transposed copy of K/V is made.
//   * Grid (B·H, ceil(Sq / block_q)): the q-heads of one kv group are
//     adjacent along x, so the blocks that read the same K/V tiles run
//     together and meet in L2; for causal attention y runs backwards, so
//     the longest q tiles (the most K/V tiles) start first.
//   * Block 4 warps. A warp owns 16 query rows (one m-tile), or at hd 64
//     in a grid of at least two blocks an SM 32 (two m-tiles, a q tile of
//     128 rows), so each K/V fragment read from shared memory feeds two
//     mma. K/V tiles of 64 keys (32 at hd 256, for registers). The Q tile
//     and the K/V tiles come in through 16-byte cp.async copies into an
//     XOR-swizzled shared layout (16-byte chunk c of row r lands at chunk
//     c ^ (r & 7), so the 8 rows an ldmatrix reads hit 8 distinct bank
//     groups), in a 2-stage ring with one barrier a tile: the next tile
//     loads while this one computes. Rows past Sq or Sk are zero-filled
//     by the copy.
//   * S = Q·Kᵀ and O += P·V are mma.sync m16n8k16 bf16 with fp32
//     accumulators. Fragments come from ldmatrix (ldmatrix.trans for V).
//     Q's fragments stay in registers at hd 64/128; at hd 256 they are
//     re-read from shared memory each k-step (another 64 registers a
//     thread would spill).
//   * The online softmax runs on the accumulator fragments: a thread
//     holds two rows' worth of columns, the row max is over the quad of 4
//     lanes that share a row, in the log2 domain (one FFMA and one
//     ex2.approx a probability, log2 e folded into the scale), with the
//     m = -inf guards.
//   * P's C fragments are converted to bf16 in registers and used as the
//     A operand of the next mma as they are (the m16n8 C layout is the
//     m16n8k16 A layout). l is one more mma: P times a ones matrix, in
//     fp32, which sums the rounded P without ALU work or shuffles.
//   * Masks at run time: the kernel walks only the K/V tiles that can
//     hold a live key for some row of its q tile, and applies the element
//     mask only on tiles that straddle the diagonal, the window edge or
//     the Sk tail. One instantiation per head size (two at hd 64).
//   * Epilogue: divide by l (0 for a row with no live key), cast to bf16,
//     stage in the warp's rows of the Q tile and write 16-byte chunks.
//   * Shared memory: (block_q + 2 stages x 2 x block_k) x hd x 2 bytes:
//     48 KB at hd 64 (40 KB with one m-tile), 80 KB at 128, 96 KB at 256.
//     ptxas's register and spill counts are in the build's .log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kStages = 2;  // K/V tiles in the ring
// A grid of fewer blocks than this a SM takes one m-tile a warp (more,
// shorter blocks); at or above it, two at hd 64.
constexpr int kMinBlocksPerSm = 2;

// Query rows a block: 4 warps x 16 x MT, MT the 16-row m-tiles a warp
// owns. MT 2 (hd 64 only: above it the accumulators leave no room) lets
// each K/V fragment read from shared memory feed two mma.
template <int MT>
__host__ __device__ constexpr int block_q() {
  return kWarps * 16 * MT;
}
// Keys a K/V tile: 64 (32 at hd 256, for registers).
template <int HD>
__host__ __device__ constexpr int block_k() {
  return HD == 256 ? 32 : 64;
}

template <int HD, int MT>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(block_q<MT>() + 2 * kStages * block_k<HD>()) * HD * sizeof(bf16);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of HD columns.
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (HD * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far under the bf16 P they feed).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16 ones: the B operand that makes an mma sum P's rows.
constexpr uint32_t kOnes = 0x3f803f80u;

// Copy a ROWS x HD tile whose row 0 is at g (row stride `stride`
// elements) into the swizzled tile at s; rows >= n_ok are zero-filled
// (their source is row 0, which is always in bounds, and no byte of it is
// read).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t s, const bf16* g, size_t stride, int n_ok,
                                          int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % kThreads == 0, "tile does not split over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = r < n_ok;
    cp_async16(s + swz<HD>(r, c), g + (ok ? r : 0) * stride + c * 8, ok);
  }
}

// grid (B * H, ceil(Sq / block_q)); block kThreads; dynamic shared
// memory smem_bytes<HD, MT>(): the Q tile, then kStages x (K tile, V tile).
template <int HD, int MT>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                              int Sk, int H, int n_kv, int causal, int window,
                              float scale_log2) {
  constexpr int BQ = block_q<MT>();
  constexpr int BK = block_k<HD>();
  constexpr int NS = kStages;
  constexpr int KS = HD / 16;  // k-steps of Q·Kᵀ
  constexpr int NT = BK / 8;   // n-tiles of S
  constexpr int DT = HD / 8;   // n-tiles of O
  constexpr bool kQRegs = HD <= 128;
  constexpr uint32_t kTileK = BK * HD * 2;  // bytes of one K (or V) tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t kv_s = q_s + BQ * HD * 2;  // stage st: K, then V

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / n_kv);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q_lo = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row of the fragment (and row + 8)
  const int tig = lane & 3;  // column pair of the fragment
  const int w_row = warp * 16 * MT;  // the warp's first row in the tile

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t q_off = (static_cast<size_t>(b) * Sq + q_lo) * q_stride + static_cast<size_t>(h) * HD;
  const bf16* k_b = k + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;
  const bf16* v_b = v + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;

  // the K/V tiles that can hold a live key for some row of this q tile
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / BK : 0;
  const int kt_end = causal ? min(n_kt, q_hi / BK + 1) : n_kt;

  auto load_kv = [&](int kt, int st) {
    const int k_lo = kt * BK;
    const uint32_t base = kv_s + st * 2 * kTileK;
    load_tile<HD, BK>(base, k_b + k_lo * kv_stride, kv_stride, Sk - k_lo, tid);
    load_tile<HD, BK>(base + kTileK, v_b + k_lo * kv_stride, kv_stride, Sk - k_lo, tid);
  };
  // prologue: Q and the first NS - 1 K/V tiles, one commit group each
  load_tile<HD, BQ>(q_s, q + q_off, q_stride, Sq - q_lo, tid);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kt_begin + i < kt_end) load_kv(kt_begin + i, i);
    cp_async_commit();
  }

  float o[MT][DT][4];
  float m[MT][2];
  // l as an mma accumulator: P (bf16, as rounded for P·V) times a ones
  // matrix, so l[mt][0] (and [1]) is row g's sum and l[mt][2] row g + 8's
  float l[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < DT; ++t) o[mt][t][0] = o[mt][t][1] = o[mt][t][2] = o[mt][t][3] = 0.f;
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = l[mt][2] = l[mt][3] = 0.f;
  }
  uint32_t qf[MT][kQRegs ? KS : 1][4];

  // ldmatrix row/chunk of this lane: matrix j = lane / 8, row lane % 8
  const int a_row = w_row + (lane & 7) + ((lane >> 3) & 1) * 8;  // Q (A operand), m-tile 0
  const int a_chunk = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) & 1) * 8;  // K (B operand, 2 n-tiles)
  const int kb_chunk = (lane >> 3) & 1;
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // V (B operand, transposed)
  const int vb_chunk = lane >> 4;
  const int r0 = q_lo + w_row + g;  // query positions: r0 + 16 mt, and + 8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) % NS;
    cp_async_wait<NS - 2>();  // this thread's copies of tile kt have landed
    // every thread's copies of tile kt are visible, and every warp is done
    // with tile kt - 1, whose stage the next load refills
    __syncthreads();
    if (kt + NS - 1 < kt_end) load_kv(kt + NS - 1, (st + NS - 1) % NS);
    cp_async_commit();
    const uint32_t k_t = kv_s + st * 2 * kTileK;
    const uint32_t v_t = k_t + kTileK;
    if constexpr (kQRegs) {
      if (kt == kt_begin) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            ldsm_x4(qf[mt][ks], q_s + swz<HD>(a_row + 16 * mt, 2 * ks + a_chunk));
        }
      }
    }

    // S = Q·Kᵀ for the warp's rows and the tile's BK keys; each K
    // fragment feeds the MT m-tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int t = 0; t < NT; ++t) s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][ks][i];
        } else {
          ldsm_x4(a[mt], q_s + swz<HD>(a_row + 16 * mt, 2 * ks + a_chunk));
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_t + swz<HD>(np * 16 + kb_row, 2 * ks + kb_chunk));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // mask only a tile that straddles the diagonal, the window edge or
    // the Sk tail
    const int k_lo = kt * BK;
    const bool need_mask = k_lo + BK > Sk || (causal && k_lo + BK - 1 > q_lo) ||
                           (window > 0 && k_lo <= q_hi - window);
    if (need_mask) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + 16 * mt + (e >> 1) * 8;
            const int kp = k_lo + t * 8 + 2 * tig + (e & 1);
            const bool live =
                kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
            if (!live) s[mt][t][e] = -CUDART_INF_F;
          }
        }
      }
    }

    // online softmax over the quad that shares each row; m is kept in the
    // log2 domain (raw score x scale x log2 e), so p = exp2(s * scale - m)
    // is one FFMA and one ex2. P goes to bf16, laid out as the A operand
    // of P·V, and l is summed from the same rounded P.
    uint32_t pa[MT][BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < NT; ++t) mx = fmaxf(mx, fmaxf(s[mt][t][2 * i], s[mt][t][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[mt][i], mx * scale_log2);
        // a row with no live key yet keeps m = -inf: guard the exp arguments
        safe[i] = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float corr = ex2(m[mt][i] - safe[i]);  // 0 while m = -inf
        m[mt][i] = m_new;
        l[mt][2 * i] *= corr;
        l[mt][2 * i + 1] *= corr;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          o[mt][t][2 * i] *= corr;
          o[mt][t][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 2 * kk + half;
          pa[mt][kk][2 * half] = pack_bf16(ex2(fmaf(s[mt][t][0], scale_log2, -safe[0])),
                                           ex2(fmaf(s[mt][t][1], scale_log2, -safe[0])));
          pa[mt][kk][2 * half + 1] = pack_bf16(ex2(fmaf(s[mt][t][2], scale_log2, -safe[1])),
                                               ex2(fmaf(s[mt][t][3], scale_log2, -safe[1])));
        }
      }
    }

    // O += P·V; each V fragment feeds the MT m-tiles; l += P·1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(l[mt], pa[mt][kk], kOnes, kOnes);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_t + swz<HD>(kk * 16 + vb_row, 2 * dp + vb_chunk));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt][kk], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt][kk], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the Q copies, where the loop ran no tile
  __syncthreads();

  // epilogue: O / l in bf16, staged in the warp's own rows of the Q tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = l[mt][2 * i];
      const float inv = li > 0.f ? 1.f / li : 0.f;  // no live key: zeros
      const int row = w_row + 16 * mt + 8 * i + g;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(o[mt][t][2 * i] * inv, o[mt][t][2 * i + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(q_s + swz<HD>(row, t) + tig * 4),
                     "r"(*reinterpret_cast<const uint32_t*>(&pr)));
      }
    }
  }
  __syncwarp();
  constexpr int CPR = HD / 8;
  bf16* o_t = out + q_off;
  for (int i = lane; i < 16 * MT * CPR; i += 32) {
    const int r = w_row + i / CPR;
    const int c = i % CPR;
    if (q_lo + r < Sq) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(q_s + swz<HD>(r, c)));
      *reinterpret_cast<uint4*>(o_t + r * q_stride + c * 8) = val;
    }
  }
}

template <int HD, int MT>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                       int Sk, int H, int n_kv, int causal, int window, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<HD, MT>;
  constexpr size_t smem = smem_bytes<HD, MT>();
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + block_q<MT>() - 1) / block_q<MT>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk, H, n_kv, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// hd 64 takes two m-tiles a warp when the grid still has kMinBlocksPerSm
// blocks an SM (a long prefill), else one (a short one: more blocks).
cudaError_t launch_hd64(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int H, int n_kv, int causal, int window, float scale,
                        cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks2 = static_cast<long long>(B) * H * ((Sq + block_q<2>() - 1) / block_q<2>());
  if (blocks2 >= static_cast<long long>(kMinBlocksPerSm) * sms)
    return launch_one<64, 2>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, stream);
  return launch_one<64, 1>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most dynamic shared memory one block takes at head size hd (0 if
// unsupported).
size_t flash_attention_tc_smem_bytes(int hd) {
  if (hd == 64) return smem_bytes<64, 2>();
  if (hd == 128) return smem_bytes<128, 1>();
  if (hd == 256) return smem_bytes<256, 1>();
  return 0;
}

// q (B, Sq, H, hd), k/v (B, Sk, n_kv, hd), out (B, Sq, H, hd), all
// bfloat16, contiguous, 16-byte aligned; H a multiple of n_kv; hd 64, 128
// or 256; window 0 for none. Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported hd).
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out, int B,
                              int Sq, int Sk, int H, int n_kv, int hd, int causal, int window,
                              float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd64(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  if (hd == 128)
    return launch_one<128, 1>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  if (hd == 256)
    return launch_one<256, 1>(q, k, v, out, B, Sq, Sk, H, n_kv, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
