// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (both called through _bwd_call, the backward of the
// _flash_mha custom_vjp). With p = exp(scale * q.k - lse) and
// delta = rowsum(do * o), computed by the wrapper:
//
//   dq = scale * sum_kv ds k       ds = p * (do.v - delta)
//   dv = sum_q p^T do              dk = scale * sum_q ds^T q
//
// Causal masking with q_offset shifting the diagonal, lse, delta and every
// sum in f32, and f32 outputs, as the TPU kernels have them. Three numeric
// modes, chosen by the wrapper from the dtype and `lowp` (the reference's
// `cdt`, flash_attention.py:222 and :268):
//
//  1. lowp (bf16 dot inputs; an f32 call is rounded to bf16 by the wrapper,
//     round-to-nearest-even as astype(bfloat16)): q, k, v, do bf16; p and
//     ds rounded to bf16 before their products. All five products (s, dp,
//     ds k, p^T do, ds^T q) run on the bf16 tensor cores with f32
//     accumulators: the tensor-core kernels below, SPLIT = false.
//  2. bf16 inputs without lowp (cdt = f32): s and dp have bf16 operands,
//     whose products are exact in f32, so they run on the tensor cores
//     unchanged. p and ds stay f32: each is split in registers into
//     hi = bf16(x) and lo = bf16(x - hi), and its product is issued twice
//     (hi, then lo, into one f32 accumulator). x - hi is exact in f32 and
//     |x - hi| <= 2^-8 |x|, so |x - hi - lo| <= 2^-16 |x|: each output
//     differs from the product with the unsplit f32 operand by at most
//     2^-16 * sum |x| |y| (times scale for dq and dk), beside the f32
//     summation-order noise any reordering has. SPLIT = true.
//  3. f32 inputs without lowp: the FFMA kernels (first part of this file),
//     whose f32 sums run in the plain GEMM's order, so their results equal
//     the plain version's bit for bit.
//
// What bounds them on the H100, at the training shape (B4 H32 S512 hd64
// causal, 16.8M live (query, key) pairs): each live pair costs 2 * hd
// FLOPs per product, 3 products in dq and 4 in dkv (5 and 6 in mode 2,
// counting each split product twice), against the bytes of q, k, v, do
// (bf16), lse, delta and the f32 outputs. In f32 the FFMA kernels are bound
// by operations (67 TFLOP/s): 0.096 and 0.128 ms. In bf16 both kernels are
// bound by bytes: 50.9 MB (dq) and 67.6 MB (dkv) are 0.0152 and 0.0202 ms
// at 3.35 TB/s, against 0.0065-0.0130 ms of tensor-core work at 989
// TFLOP/s. The f32 outputs are a third and a half of those bytes.
//
// The FFMA design (mode 3): the FMAs are fed from shared memory through
// 4 x 4 register tiles (8 LDS.128 per 64 FMAs), 256 threads as a 16 x 16
// grid (ty, tx), 64-row and 64-key tiles.
//  - flash_bwd_dq: one block per (b, h, 64-row query tile). Q, dO, lse and
//    delta stay resident; the block loops over KV tiles up to the causal
//    diagonal. Thread (ty, tx) computes s and dp for rows ty + 16i and keys
//    tx + 16j, writes ds to shared memory, then accumulates dq for rows
//    ty + 16i and hd/16 contiguous head dims in registers.
//  - flash_bwd_dkv: one block per (b, h, 64-key tile). K and V stay
//    resident; the block loops over query tiles from the first one that
//    reaches the band. Each thread computes the transposed tiles directly,
//    s^T = K Q^T and dp^T = V dO^T, and stores p^T and ds^T key-major, so
//    the dk/dv products read one broadcast float4 per row.
// Row strides are padded (hd + 4, 64 + 16 floats) so that the lanes of each
// LDS.128 phase hit distinct banks or one broadcast address.
//
// The tensor-core design (modes 1 and 2): a block is one consumer
// warpgroup (128 threads, 64 rows: the M of one wgmma) and one producer
// warp. The producer's lane 0 loads tiles with TMA through 3-D tensor maps
// (hd, S, b*h), so a tile's rows past S and columns past hd fill with zeros
// and never come from the next head. Rows are 64 bf16 (128 bytes) wide,
// with the 128-byte swizzle; hd 16 and 32 are zero-padded to 64 columns and
// hd 128 is two 64-column slabs. Streamed tiles go through a ring of
// kStages stages, each with a `full` mbarrier (TMA bytes, and in dkv the
// producer lanes that copy lse and delta beside them) and an `empty` one
// (the 128 consumers, once their wgmmas have read the stage).
//  - dq: one block per (b, h, 64 query rows), the causal blocks with the
//    most tiles first. Q and dO stay resident. Per 64-key tile: s = Q K^T
//    and dp = dO V^T as wgmma m64n64k16 from shared memory (K-major), p and
//    ds in the accumulator registers, ds converted to bf16 (hi, and lo in
//    mode 2) in registers and fed back as the register A operand of
//    dq += ds K, with K the shared-memory B operand read MN-major.
//  - dkv: one block per (b, h, 64 keys). K and V stay resident. Per 64-row
//    query tile: s^T = K Q^T and dp^T = V dO^T, so p^T and ds^T are already
//    in the accumulator layout that the register A operand of dv += p^T dO
//    and dk += ds^T Q takes; they never go to shared memory.
//  - Masking: causal tiles that are fully masked are never loaded; the mask
//    is evaluated only on the diagonal tile and the ragged tails.
//  - p = 2^(s * scale * log2 e - lse * log2 e), one FMA and one ex2 on the
//    special-function unit per element, subnormal results flushed to zero.
//  - Registers: per thread, s and dp take 32 each, dq 32 (hd <= 64) or 64
//    (hd 128), and the bf16 fragments 16 (32 in mode 2). dkv at hd 128 is
//    the worst case: dk and dv take 128 registers. It is built for one
//    block per SM (255 registers a thread) and, at hd 128 only, waits for
//    dv's products before it builds ds^T's fragments, so p^T's and ds^T's
//    fragments are never live together: 128 + 64 + 32 at the peak, 252
//    with addressing and no spills. Every other case is built for two
//    blocks per SM (at most 204 registers; dq at hd 64 takes about 120 and
//    so fits three).
//  - What still keeps them from the bound (their times are in PERF.md): a
//    block's tiles run as one dependent chain inside one warpgroup
//    (products, wait, exp, products, wait), and blocks are short (4.5
//    tiles on average at the causal train shape), so the latency of each
//    block's first loads is exposed. Overlapping one tile's exp with the
//    next tile's products, and persistent blocks, are the next steps.
//
// Layout: q and do (B,H,Sq,HD), k and v (B,H,Sk,HD), contiguous, one dtype
// (f32 for the FFMA kernels, bf16 for the tensor-core ones), HD in
// {16, 32, 64, 128}; lse and delta (B,H,Sq) f32; dq (B,H,Sq,HD), dk and dv
// (B,H,Sk,HD) f32. The kernels allocate nothing and launch on the caller's
// stream.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ===========================================================================
// FFMA kernels: f32 inputs without lowp
// ===========================================================================
// These kernels are kept as first written and measured, for f32 only. Their
// lowp flag is 0 on every launch (an f32 call with lowp is rounded to bf16
// by the wrapper and runs the tensor-core kernels); it stays because the
// kernels compile as they were measured with it: without it ptxas
// allocates dq's registers otherwise, 17% slower at Sq 300, Sk 373.

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of (ty, tx)
constexpr int kPRow = kBK + 16;    // ds / p^T row stride: a warp's two rows on opposite bank halves

__device__ __forceinline__ float dot_in(float x, bool lowp) {
  return lowp ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// four consecutive elements of a global row
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__host__ __device__ constexpr int row_stride(int hd) { return hd + 4; }

// Stage rows r0 .. r0 + 63 of a (rows, HD) slab into shared memory
// [64][HD + 4] as f32 dot inputs; rows at or past `limit` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int limit, bool lowp) {
  constexpr int ROW = row_stride(HD);
  constexpr int Q4 = HD / 4;
  for (int g = threadIdx.x; g < kBQ * Q4; g += kThreads) {
    const int r = g / Q4, c = (g % Q4) * 4;
    const int row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < limit) {
      x = load4(src + (size_t)row * HD + c);
      x.x = dot_in(x.x, lowp); x.y = dot_in(x.y, lowp);
      x.z = dot_in(x.z, lowp); x.w = dot_in(x.w, lowp);
    }
    *reinterpret_cast<float4*>(dst + r * ROW + c) = x;
  }
}

// acc[i][jn] += a_rows(ty + 16i) . b_rows(tx + 16jn) over HD: the 4 x 4
// register tile of a product of two [64][HD + 4] shared-memory tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int ROW = row_stride(HD);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) acc[i][jn] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    float4 af[4], bf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      af[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ROW + d);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
      bf[jn] = *reinterpret_cast<const float4*>(b + (tx + 16 * jn) * ROW + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        acc[i][jn] = fmaf(af[i].x, bf[jn].x, acc[i][jn]);
        acc[i][jn] = fmaf(af[i].y, bf[jn].y, acc[i][jn]);
        acc[i][jn] = fmaf(af[i].z, bf[jn].z, acc[i][jn]);
        acc[i][jn] = fmaf(af[i].w, bf[jn].w, acc[i][jn]);
      }
  }
}

// N contiguous floats from shared memory, 16 bytes at a time where N allows
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 v = reinterpret_cast<const float4*>(p)[u];
      out[4 * u] = v.x; out[4 * u + 1] = v.y; out[4 * u + 2] = v.z; out[4 * u + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// acc[i][e] += sum_kk w[(ty + 16i)][kk] * x[kk][tx * DPT + e]: w is a
// [64][kPRow] shared tile (ds, or p^T / ds^T), x a [64][HD + 4] one
template <int HD>
__device__ __forceinline__ void tile_acc(const float* w, const float* x,
                                         int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
  constexpr int ROW = row_stride(HD);
  constexpr int DPT = HD / 16;
#pragma unroll 4
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 wf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wf[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * kPRow + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[DPT];
      lds<DPT>(x + (kk + u) * ROW + tx * DPT, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = u == 0 ? wf[i].x : u == 1 ? wf[i].y : u == 2 ? wf[i].z : wf[i].w;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(c, xv[e], acc[i][e]);
      }
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t base,
                                           int r0, int limit, int ty, int tx,
                                           float mul, const float (&acc)[4][HD / 16]) {
  constexpr int DPT = HD / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row < limit) {
      float* o = out + (base + row) * HD + tx * DPT;
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[e] = acc[i][e] * mul;
    }
  }
}

constexpr size_t smem_floats(int hd) {
  return 4 * (size_t)kBQ * row_stride(hd) + 2 * (size_t)kBQ * kPRow + 2 * kBQ;
}

// ---------------------------------------------------------------------------
// dq: one block per (b, h, 64-row query tile), looping over KV tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int causal,
                    int q_offset, float scale, int lowp_flag) {
  constexpr int ROW = row_stride(HD);
  constexpr int DPT = HD / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][ROW]
  float* dos = qs + kBQ * ROW;                  // [kBQ][ROW]
  float* ks = dos + kBQ * ROW;                  // [kBK][ROW]
  float* vs = ks + kBK * ROW;                   // [kBK][ROW]
  float* dss = vs + kBK * ROW;                  // [kBQ][kPRow]

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int row0 = (int)blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;

  stage<T, HD>(qs, q + bh * Sq * HD, row0, Sq, lowp);
  stage<T, HD>(dos, dout + bh * Sq * HD, row0, Sq, lowp);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    // KV tiles above the diagonal of this block's last live row are skipped
    const int last_key = min(row0 + kBQ - 1, Sq - 1) + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kBK;
    __syncthreads();  // Q and dO are staged; the previous tile's K, V, ds are consumed
    stage<T, HD>(ks, kb, key0, Sk, lowp);
    stage<T, HD>(vs, vb, key0, Sk, lowp);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(qs, ks, ty, tx, s);
    tile_dot<HD>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int key = key0 + tx + 16 * jn;
        const bool ok = key < Sk && row < Sq && (!causal || key <= row + q_offset);
        const float p = ok ? expf(scale * s[i][jn] - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * kPRow + tx + 16 * jn] = dot_in(p * (dp[i][jn] - delta_r[i]), lowp);
      }
    }
    __syncthreads();
    tile_acc<HD>(dss, ks, ty, tx, acc);  // dq += ds k
  }
  store_rows<HD>(dq, bh * Sq, row0, Sq, ty, tx, scale, acc);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (b, h, 64-key tile), looping over query tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                     int causal, int q_offset, float scale, int lowp_flag) {
  constexpr int ROW = row_stride(HD);
  constexpr int DPT = HD / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBK][ROW]
  float* vs = ks + kBK * ROW;                   // [kBK][ROW]
  float* qs = vs + kBK * ROW;                   // [kBQ][ROW]
  float* dos = qs + kBQ * ROW;                  // [kBQ][ROW]
  float* pts = dos + kBQ * ROW;                 // p^T  [kBK][kPRow]
  float* dsts = pts + kBK * kPRow;              // ds^T [kBK][kPRow]
  float* lse_s = dsts + kBK * kPRow;            // [kBQ]
  float* delta_s = lse_s + kBQ;                 // [kBQ]

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int key0 = (int)blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * HD;
  const T* dob = dout + bh * Sq * HD;

  stage<T, HD>(ks, k + bh * Sk * HD, key0, Sk, lowp);
  stage<T, HD>(vs, v + bh * Sk * HD, key0, Sk, lowp);

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int n_q = (Sq + kBQ - 1) / kBQ;
  int first = 0;
  if (causal) {
    // query tiles whose last row is still above this key tile's first
    // column see none of it: start at the first one that reaches the band
    const int first_row = key0 - q_offset;
    first = first_row <= 0 ? 0 : first_row / kBQ;
  }

  for (int qt = first; qt < n_q; ++qt) {
    const int r0 = qt * kBQ;
    __syncthreads();  // K and V are staged; the previous tile's Q, dO, p^T, ds^T are consumed
    stage<T, HD>(qs, qb, r0, Sq, lowp);
    stage<T, HD>(dos, dob, r0, Sq, lowp);
    if (t < kBQ) {
      const int row = r0 + t;
      lse_s[t] = row < Sq ? lse[bh * Sq + row] : 0.f;
      delta_s[t] = row < Sq ? delta[bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T for keys ty + 16i and query rows tx + 16jn
    float s[4][4], dp[4][4];
    tile_dot<HD>(ks, qs, ty, tx, s);
    tile_dot<HD>(vs, dos, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + ty + 16 * i;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int c = tx + 16 * jn;
        const int row = r0 + c;
        const bool ok = key < Sk && row < Sq && (!causal || key <= row + q_offset);
        const float p = ok ? expf(scale * s[i][jn] - lse_s[c]) : 0.f;
        pts[(ty + 16 * i) * kPRow + c] = dot_in(p, lowp);
        dsts[(ty + 16 * i) * kPRow + c] = dot_in(p * (dp[i][jn] - delta_s[c]), lowp);
      }
    }
    __syncthreads();
    tile_acc<HD>(pts, dos, ty, tx, dv_acc);   // dv += p^T do
    tile_acc<HD>(dsts, qs, ty, tx, dk_acc);   // dk += ds^T q
  }
  store_rows<HD>(dk, bh * Sk, key0, Sk, ty, tx, scale, dk_acc);
  store_rows<HD>(dv, bh * Sk, key0, Sk, ty, tx, 1.f, dv_acc);
}

// ===========================================================================
// Tensor-core kernels: bf16 inputs (lowp, SPLIT = false; or not, SPLIT = true)
// ===========================================================================

constexpr int kRows = 64;                 // rows of a block's resident tile: one wgmma M
constexpr int kStages = 2;                // ring of streamed tiles (3 and 4 were no faster)
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr uint32_t kSlab = 64 * 128;      // bytes of [64 rows][64 bf16], 128-byte rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of some 20 s
// (2^35 cycles) traps, so that a lost arrival fails the launch, not the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 columns, 64 rows, 1 head) of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles of 128-byte
// rows (start, leading and stride byte offsets in 16-byte units; layout 1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major (the reduced dim along the row): 8-row groups 1024 bytes apart;
// a 16-wide k step starts 32 bytes further along the row
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major (the reduced dim down the rows): 8-row groups 1024 bytes apart,
// 64-column slabs kSlab apart; a 16-deep k step starts 2048 bytes further
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, kSlab, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses to accumulators across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64, f32) = (acc ? d : 0) + A (smem, K-major) * B (smem, K-major), 128B-swizzled
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (m64n64, f32) += A (registers, bf16) * B (smem, MN-major, 128B-swizzled)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A (registers, bf16) * B (smem, MN-major, 128B-swizzled)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (exp2f's handling of subnormal results costs extra instructions per
// element; a p that small changes no f32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand (m64k16 bf16) of chunk kk from an m64n64 f32
// accumulator x whose columns are the reduced dim: register r holds columns
// 16kk + 8(r / 2) + 2 tig + {0, 1} of row gid + 8 (r % 2), which are x's
// elements 8kk + 2r and 8kk + 2r + 1. hi is x rounded to bf16 (RNE); with
// SPLIT, lo is the residual x - hi rounded to bf16.
template <bool SPLIT>
__device__ __forceinline__ void a_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(x0, x1);
      if constexpr (SPLIT) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
        lo[kk][r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
      }
    }
}

// acc += frag(x) B over 64 rows of B, B's k-th 16 rows at b_addr + 2048 k
template <int HDP, bool SPLIT>
__device__ __forceinline__ void product_rs(float (&acc)[HDP / 2], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor_desc(b_addr + 2048 * kk);
    wgmma_rs<HDP>(acc, hi[kk], db);
    if constexpr (SPLIT) wgmma_rs<HDP>(acc, lo[kk], db);
  }
}

// s = A B^T and t = C D^T over HDP columns, all four K-major 64-row tiles
template <int HDP>
__device__ __forceinline__ void products_ss(float (&s)[32], uint32_t a, uint32_t b,
                                            float (&t)[32], uint32_t c, uint32_t d) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
    wgmma_ss_n64(s, kmajor_desc(a + off), kmajor_desc(b + off), kk);
    wgmma_ss_n64(t, kmajor_desc(c + off), kmajor_desc(d + off), kk);
  }
}

// rows gid and gid + 8 of the warp's 16 of an m64nHDP accumulator, times
// mul, into out (row-major, hd wide); rows at or past limit, columns past hd
// are not stored
template <int HDP>
__device__ __forceinline__ void store_acc(float* __restrict__ out, int ra, int limit, int hd,
                                          float mul, const float (&acc)[HDP / 2]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int row = ra + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * tig;
    if (row < limit && col < hd)
      *reinterpret_cast<float2*>(out + (size_t)row * hd + col) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* bar, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);  // the resident tiles
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar[1 + s], full_count);
      mbar_init(&bar[1 + kStages + s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

constexpr size_t tc_smem_bytes(int hdp, bool dkv) {
  return 1024 + (2 + 2 * kStages) * (size_t)(hdp / 64) * kSlab +
         (dkv ? 2 * kStages * kRows * 4 : 0) + 8 * (1 + 2 * kStages);
}

// ---------------------------------------------------------------------------
// dq: one block per (b, h, 64 query rows), streaming K and V tiles
// ---------------------------------------------------------------------------

template <int HDP, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int Sq, int Sk, int hd, int causal, int q_offset,
                float scale) {
  constexpr int NS = HDP / 64;
  constexpr uint32_t kTile = NS * kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sDO = sQ + kTile;
  uint8_t* sK = sDO + kTile;           // [kStages] tiles
  uint8_t* sV = sK + kStages * kTile;  // [kStages] tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  // the causal blocks with the most KV tiles start first
  const int row0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kRows;
  const int bh = blockIdx.y;
  int n_kv = (Sk + 63) / 64;
  if (causal) {
    const int last_key = min(row0 + kRows - 1, Sq - 1) + q_offset;
    n_kv = last_key < 0 ? 0 : min(n_kv, last_key / 64 + 1);
  }
  init_barriers(bar, 1);

  if (threadIdx.x >= kConsumers) {  // producer warp: lane 0 issues every load
    if (threadIdx.x == kConsumers && n_kv > 0) {
      mbar_arrive_expect_tx(&bar[0], 2 * kTile);
      for (int c = 0; c < NS; ++c) {
        tma_load(sQ + c * kSlab, &tm_q, &bar[0], 64 * c, row0, bh);
        tma_load(sDO + c * kSlab, &tm_do, &bar[0], 64 * c, row0, bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        for (int c = 0; c < NS; ++c) {
          tma_load(sK + s * kTile + c * kSlab, &tm_k, &full[s], 64 * c, 64 * j, bh);
          tma_load(sV + s * kTile + c * kSlab, &tm_v, &full[s], 64 * c, 64 * j, bh);
        }
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int ra = row0 + 16 * (threadIdx.x >> 5) + gid, rb = ra + 8;
  const size_t rows = (size_t)bh * Sq;
  const float sl2 = scale * kLog2e;
  const float lse_a = ra < Sq ? lse[rows + ra] * kLog2e : 0.f;
  const float lse_b = rb < Sq ? lse[rows + rb] * kLog2e : 0.f;
  const float delta_a = ra < Sq ? delta[rows + ra] : 0.f;
  const float delta_b = rb < Sq ? delta[rows + rb] : 0.f;

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  if (n_kv > 0) mbar_wait(&bar[0], 0);
  const uint32_t q_addr = smem_u32(sQ), do_addr = smem_u32(sDO);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();  // the wgmmas below are warp-aligned
    const uint32_t k_addr = smem_u32(sK + s * kTile), v_addr = smem_u32(sV + s * kTile);

    float sc[32], ds[32];  // s, then dp and ds
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = ds[i] = 0.f;
    wgmma_fence();
    products_ss<HDP>(sc, q_addr, k_addr, ds, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(ds);

    const int key0 = 64 * j;
    const bool edge = key0 + 64 > Sk || (causal && key0 + 63 > row0 + q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lower = (i & 2) != 0;  // row gid + 8
      float p = exp2_ftz(fmaf(sc[i], sl2, -(lower ? lse_b : lse_a)));
      if (edge) {
        const int key = key0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (key >= Sk || (causal && key > (lower ? rb : ra) + q_offset)) p = 0.f;
      }
      ds[i] = p * (ds[i] - (lower ? delta_b : delta_a));
    }
    uint32_t hi[4][4], lo[4][4];
    a_fragments<SPLIT>(ds, hi, lo);
    wgmma_fence();
    product_rs<HDP, SPLIT>(acc, hi, lo, k_addr);  // dq += ds K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  store_acc<HDP>(dq + rows * hd, ra, Sq, hd, scale, acc);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (b, h, 64 keys), streaming Q and dO tiles
// ---------------------------------------------------------------------------

template <int HDP, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, HDP == 64 ? 2 : 1)
flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int hd,
                 int causal, int q_offset, float scale) {
  constexpr int NS = HDP / 64;
  constexpr uint32_t kTile = NS * kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1024(smem_raw);
  uint8_t* sV = sK + kTile;
  uint8_t* sQ = sV + kTile;             // [kStages] tiles
  uint8_t* sDO = sQ + kStages * kTile;  // [kStages] tiles
  float* lse_s = reinterpret_cast<float*>(sDO + kStages * kTile);  // [kStages][64], times log2 e
  float* delta_s = lse_s + kStages * kRows;                         // [kStages][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(delta_s + kStages * kRows);
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  const int key0 = (int)blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const size_t rows = (size_t)bh * Sq;
  int first = 0;
  if (causal) {
    // query tiles whose last row is still above this key tile's first
    // column see none of it: start at the first one that reaches the band
    const int first_row = key0 - q_offset;
    first = first_row <= 0 ? 0 : first_row / 64;
  }
  const int n_tiles = max(0, (Sq + 63) / 64 - first);
  init_barriers(bar, 32);

  if (threadIdx.x >= kConsumers) {  // producer warp: lse and delta by all lanes, TMA by lane 0
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(&bar[0], 2 * kTile);
      for (int c = 0; c < NS; ++c) {
        tma_load(sK + c * kSlab, &tm_k, &bar[0], 64 * c, key0, bh);
        tma_load(sV + c * kSlab, &tm_v, &bar[0], 64 * c, key0, bh);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages, round = i / kStages;
      const int r0 = (first + i) * 64;
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
      for (int r = lane; r < kRows; r += 32) {
        const bool ok = r0 + r < Sq;
        lse_s[s * kRows + r] = ok ? lse[rows + r0 + r] * kLog2e : 0.f;
        delta_s[s * kRows + r] = ok ? delta[rows + r0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        for (int c = 0; c < NS; ++c) {
          tma_load(sQ + s * kTile + c * kSlab, &tm_q, &full[s], 64 * c, r0, bh);
          tma_load(sDO + s * kTile + c * kSlab, &tm_do, &full[s], 64 * c, r0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int ka = key0 + 16 * (threadIdx.x >> 5) + gid, kb = ka + 8;
  const float sl2 = scale * kLog2e;
  float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(&bar[0], 0);
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    __syncwarp();  // the wgmmas below are warp-aligned
    const uint32_t q_addr = smem_u32(sQ + s * kTile), do_addr = smem_u32(sDO + s * kTile);

    float pt[32], dst[32];  // s^T then p^T; dp^T then ds^T
#pragma unroll
    for (int e = 0; e < 32; ++e) pt[e] = dst[e] = 0.f;
    wgmma_fence();
    products_ss<HDP>(pt, k_addr, q_addr, dst, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pt);
    fence_regs(dst);

    const int r0 = (first + i) * 64;
    const bool edge = r0 + 64 > Sq || (causal && key0 + 63 > r0 + q_offset);
    const float* ls = lse_s + s * kRows;
    const float* dl = delta_s + s * kRows;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * tig;  // this thread's query columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jj + e;
        float p = exp2_ftz(fmaf(pt[x], sl2, -((e & 1) ? l2.y : l2.x)));
        if (edge) {
          const int row = r0 + c + (e & 1);
          if (row >= Sq || (causal && ((e & 2) ? kb : ka) > row + q_offset)) p = 0.f;
        }
        dst[x] = p * (dst[x] - ((e & 1) ? d2.y : d2.x));
        pt[x] = p;
      }
    }
    {
      uint32_t hi[4][4], lo[4][4];
      a_fragments<SPLIT>(pt, hi, lo);
      wgmma_fence();
      product_rs<HDP, SPLIT>(dv_acc, hi, lo, do_addr);  // dv += p^T dO
      if constexpr (HDP == 128) {  // free p^T's fragments before ds^T's are built
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
      }
    }
    {
      uint32_t hi[4][4], lo[4][4];
      a_fragments<SPLIT>(dst, hi, lo);
      wgmma_fence();
      product_rs<HDP, SPLIT>(dk_acc, hi, lo, q_addr);  // dk += ds^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
    }
    mbar_arrive(&empty[s]);
  }
  const size_t keys = (size_t)bh * Sk;
  store_acc<HDP>(dk + keys * hd, ka, Sk, hd, scale, dk_acc);
  store_acc<HDP>(dv + keys * hd, ka, Sk, hd, 1.f, dv_acc);
}

// ===========================================================================
// launch
// ===========================================================================

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int BH, Sq, Sk, hd, causal, q_offset;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool DQ, int HD>
cudaError_t launch_ffma(const Args& a) {
  constexpr size_t bytes = smem_floats(HD) * sizeof(float);
  const float *q = (const float*)a.q, *k = (const float*)a.k, *v = (const float*)a.v,
              *dout = (const float*)a.dout, *lse = (const float*)a.lse,
              *delta = (const float*)a.delta;
  if constexpr (DQ) {
    auto kernel = flash_bwd_dq_kernel<float, HD>;
    const cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.BH);
    kernel<<<grid, kThreads, bytes, a.stream>>>(q, k, v, dout, lse, delta, (float*)a.out0, a.Sq,
                                                a.Sk, a.causal, a.q_offset, a.scale, 0);
  } else {
    auto kernel = flash_bwd_dkv_kernel<float, HD>;
    const cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kBK - 1) / kBK, a.BH);
    kernel<<<grid, kThreads, bytes, a.stream>>>(q, k, v, dout, lse, delta, (float*)a.out0,
                                                (float*)a.out1, a.Sq, a.Sk, a.causal,
                                                a.q_offset, a.scale, 0);
  }
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t dispatch_ffma(const Args& a) {
  switch (a.hd) {
    case 16: return launch_ffma<DQ, 16>(a);
    case 32: return launch_ffma<DQ, 32>(a);
    case 64: return launch_ffma<DQ, 64>(a);
    default: return launch_ffma<DQ, 128>(a);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library needs no link against libcuda
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (hd, S, b*h) bf16 tensor in boxes of 64 columns x 64 rows x 1 head, the
// 128-byte swizzle; elements past hd or S read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* base, int hd, int S, int BH) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};  // bytes
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool DQ, int HDP, bool SPLIT>
cudaError_t launch_tc(const Args& a, const CUtensorMap (&m)[4]) {
  constexpr size_t bytes = tc_smem_bytes(HDP, !DQ);
  const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
  if constexpr (DQ) {
    auto kernel = flash_bwd_dq_tc<HDP, SPLIT>;
    const cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kRows - 1) / kRows, a.BH);
    kernel<<<grid, kTcThreads, bytes, a.stream>>>(m[0], m[1], m[2], m[3], lse, delta,
                                                  (float*)a.out0, a.Sq, a.Sk, a.hd, a.causal,
                                                  a.q_offset, a.scale);
  } else {
    auto kernel = flash_bwd_dkv_tc<HDP, SPLIT>;
    const cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kRows - 1) / kRows, a.BH);
    kernel<<<grid, kTcThreads, bytes, a.stream>>>(m[0], m[1], m[2], m[3], lse, delta,
                                                  (float*)a.out0, (float*)a.out1, a.Sq, a.Sk,
                                                  a.hd, a.causal, a.q_offset, a.scale);
  }
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t dispatch_tc(const Args& a, bool split) {
  CUtensorMap m[4];  // q, k, v, do
  cudaError_t err;
  if ((err = tensor_map(&m[0], a.q, a.hd, a.Sq, a.BH)) != cudaSuccess ||
      (err = tensor_map(&m[1], a.k, a.hd, a.Sk, a.BH)) != cudaSuccess ||
      (err = tensor_map(&m[2], a.v, a.hd, a.Sk, a.BH)) != cudaSuccess ||
      (err = tensor_map(&m[3], a.dout, a.hd, a.Sq, a.BH)) != cudaSuccess)
    return err;
  if (a.hd <= 64)
    return split ? launch_tc<DQ, 64, true>(a, m) : launch_tc<DQ, 64, false>(a, m);
  return split ? launch_tc<DQ, 128, true>(a, m) : launch_tc<DQ, 128, false>(a, m);
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1, int B,
        int H, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
        int is_bf16, int lowp, int device, void* stream) {
  if (B * H > 65535 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  // lowp with f32 inputs is rounded to bf16 by the caller
  if (!is_bf16 && lowp) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, dout, lse, delta, out0, out1, B * H, Sq, Sk, hd, causal,
               q_offset, scale, (cudaStream_t)stream};
  err = is_bf16 ? dispatch_tc<DQ>(a, lowp == 0) : dispatch_ffma<DQ>(a);
  return (int)err;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not built for. bf16
// inputs run the tensor-core kernels (split products unless lowp); f32
// inputs the FFMA ones, and only without lowp.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int B, int H,
                 int Sq, int Sk, int hd, int causal, int q_offset, float scale,
                 int is_bf16, int lowp, int device, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, nullptr, B, H, Sq, Sk, hd,
                   causal, q_offset, scale, is_bf16, lowp, device, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B,
                  int H, int Sq, int Sk, int hd, int causal, int q_offset,
                  float scale, int is_bf16, int lowp, int device, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, hd,
                    causal, q_offset, scale, is_bf16, lowp, device, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
