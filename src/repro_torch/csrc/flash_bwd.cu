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
//  3. f32 inputs without lowp: the FFMA kernels (first part of this file).
//     Every f32 sum runs in order inside one thread, as a plain GEMM's
//     does (over head dims for s and dp, over keys or query rows for dq, dk
//     and dv), and p = 2^(s * scale * log2 e - lse * log2 e) on the
//     special-function unit: the results differ from the plain version's
//     (torch.exp) by a few ulp of p, ~1e-6 at the training shape, and two
//     calls give the same bits.
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
// The FFMA design (mode 3). What holds it from the FFMA bound is shared
// memory: a warp's LDS delivers one float to each lane per wavefront, and an
// SM serves one wavefront a cycle against 4 x 32 FMAs, so a lane may load
// at most one float per 4 FMAs. A lane tile of a x b outputs loads a + b
// floats per a * b FMAs: 4 x 8 loads 0.375 a FMA (at most 67% of the FFMA
// rate), 8 x 8 would load 0.25. 8 x 8 needs 64 accumulators per product,
// and s and dp are live together beside dq's (or dk's and dv's): at 255
// registers it spilled, and one warp per SMSP ran S alone slower than this
// whole kernel (PERF.md, section 6). So lanes hold 4 x 8 (dkv at hd 128:
// 2 x 8).
//  - Blocks: 64 query rows (dq) or 64 keys (dkv), 4 warps (8 for dkv at hd
//    128); a warp owns 16 (8) consecutive rows or keys, and a lane (ry, cx)
//    = (lane / 8, lane % 8) rows or keys ry + 4i against the streamed
//    tile's keys or rows cx + 8j. Two blocks an SM (one at hd 128).
//  - Streamed tiles (K, V in dq; Q, dO in dkv, with lse and delta in the
//    pad column of each Q and dO row) go through a 2-stage ring of 16-byte
//    cp.async copies: the next tile's copies are issued right after the one
//    block barrier of a tile, so they overlap all of this tile's FMAs. The
//    resident tiles (Q, dO in dq; K, V in dkv) come in the first group.
//  - s and dp (s^T, dp^T) run interleaved in one loop, two head dims a step
//    (LDS.64). p and ds stay in registers; the third product (dq += ds K;
//    dv += p^T dO and dk += ds^T Q) reads them through a warp-private
//    exchange buffer, 32 keys or rows at a time behind __syncwarp: lane tile
//    4 x 8 again (rows by head dims), one broadcast float4 of ds a row.
//  - Rows are hd + 4 floats apart and exchange rows 40, so every LDS of a
//    quarter-warp and every exchange store hits distinct banks.
//  - Causal blocks launch heaviest first: dq's blockIdx.x counts down the
//    query tiles, and dkv's key tile 0 already sees every query tile.
//  - Shared memory (hd 64): 6 tiles of 64 x 68 floats and 4 x 16 x 40 for
//    the exchange, 114,688 bytes a block. Registers (-Xptxas -v, sm_90a,
//    CUDA 12.8): dq 168, 168, 254, 254 and dkv 168, 250, 254, 214 at hd 16,
//    32, 64, 128, no spills.
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
// Shared by both designs
// ===========================================================================

constexpr int kMaxGridY = 65535;  // heads per launch: the limit of grid.y
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (exp2f's handling of subnormal results costs extra instructions per
// element; a p that small changes no f32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ===========================================================================
// FFMA kernels: f32 inputs without lowp
// ===========================================================================

constexpr int kFRows = 64;    // rows (dq) or keys (dkv) of a block, and of each streamed tile
constexpr int kFStages = 2;   // ring of streamed tiles
constexpr int kHalf = 32;     // streamed rows or keys a warp's exchange buffer holds
constexpr int kXRow = kHalf + 8;  // its row stride: the lanes' stores hit 32 distinct banks

// The block's shape for one kernel and head dim. A lane holds NI rows (dq)
// or keys (dkv), 4 apart, against 8 keys or rows, 8 apart; a warp owns 4 NI
// consecutive rows or keys of the block. NI is 4, or 2 for dkv at hd 128,
// whose dk and dv accumulators (2 x 16 a row) would not fit beside 4 rows.
template <int HD, bool DQ>
struct Ffma {
  static constexpr int NI = (!DQ && HD == 128) ? 2 : 4;
  static constexpr int WR = 4 * NI;            // rows or keys a warp owns
  static constexpr int WARPS = kFRows / WR;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROW = HD + 4;           // floats of a staged row
  static constexpr int SLAB = kFRows * ROW;    // floats of a staged 64-row tile
  static constexpr int DPT = HD / 8;           // head dims of a lane's accumulators
  // two resident tiles, kFStages pairs of streamed ones, the exchange buffers
  static constexpr size_t SMEM =
      ((size_t)(2 + 2 * kFStages) * SLAB + (size_t)WARPS * WR * kXRow) * sizeof(float);
  static constexpr int MIN_BLOCKS = HD == 128 ? 1 : 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Issue the copies of rows r0 .. r0 + 63 of a (rows, HD) f32 slab into
// shared [64][HD + 4], 16 bytes each; rows at or past `limit` fill with zeros.
template <int HD, int THREADS>
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src, int r0,
                                            int limit) {
  constexpr int ROW = HD + 4, Q4 = HD / 4;
#pragma unroll
  for (int n = 0; n < kFRows * Q4 / THREADS; ++n) {
    const int g = (int)threadIdx.x + n * THREADS;
    const int r = g / Q4, c = (g % Q4) * 4;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * ROW + c, src + (size_t)(ok ? r0 + r : 0) * HD + c, ok);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// s[i][j] = sum over d, in order, of a[4i][d] * b[8j][d], and t likewise
// from c and e: a lane's two NI x 8 register tiles of the products that
// reduce over the head dim (s and dp; s^T and dp^T). a, b, c and e point at
// the lane's first row of four [.][HD + 4] tiles. The two products run in
// one loop, two head dims a step: 2 NI + 16 LDS.64 feed 32 NI FMAs that are
// independent of each other.
template <int HD, int NI>
__device__ __forceinline__ void dot_tiles(const float* a, const float* b, float (&s)[NI][8],
                                          const float* c, const float* e, float (&t)[NI][8]) {
  constexpr int ROW = HD + 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 2) {
    float2 bf[8], ef[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bf[j] = *reinterpret_cast<const float2*>(b + 8 * j * ROW + d);
      ef[j] = *reinterpret_cast<const float2*>(e + 8 * j * ROW + d);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float2 af = *reinterpret_cast<const float2*>(a + 4 * i * ROW + d);
      const float2 cf = *reinterpret_cast<const float2*>(c + 4 * i * ROW + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(af.x, bf[j].x, s[i][j]);
        t[i][j] = fmaf(cf.x, ef[j].x, t[i][j]);
        s[i][j] = fmaf(af.y, bf[j].y, s[i][j]);
        t[i][j] = fmaf(cf.y, ef[j].y, t[i][j]);
      }
    }
  }
}

// The first head dim of lane column group cx: 4 contiguous dims every 32
// (hd >= 32), or 2 contiguous dims (hd 16)
template <int HD>
__device__ __forceinline__ int lane_col(int cx) {
  return HD >= 32 ? 4 * cx : 2 * cx;
}

// the lane's DPT head dims of one staged row (p at the lane's first one)
template <int HD>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[HD / 8]) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int m = 0; m < HD / 32; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(p + 32 * m);
      x[4 * m] = v.x; x[4 * m + 1] = v.y; x[4 * m + 2] = v.z; x[4 * m + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

// acc[i][e] += sum over kk < 32, in order, of w[4i][kk] * x[kk][e]: w is the
// lane's first row of its warp's exchange buffer (ds, p^T or ds^T), x the
// lane's first head dim of the half's first row in a [.][HD + 4] tile
// (K in dq; dO or Q in dkv). Per 4 kk: NI + 4 HD / 32 loads feed 4 NI DPT FMAs.
template <int HD, int NI>
__device__ __forceinline__ void acc_tile(const float* w, const float* x,
                                         float (&acc)[NI][HD / 8]) {
  constexpr int ROW = HD + 4, DPT = HD / 8;
#pragma unroll 2
  for (int kk = 0; kk < kHalf; kk += 4) {
    float4 wf[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) wf[i] = *reinterpret_cast<const float4*>(w + 4 * i * kXRow + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[DPT];
      load_cols<HD>(x + (kk + u) * ROW, xv);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float c = lane_of(wf[i], u);
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(c, xv[e], acc[i][e]);
      }
    }
  }
}

// Write the 32 (of 64) streamed rows or keys of half h of a lane's NI x 8
// tile into its warp's exchange buffer, then let the warp read them
template <int NI>
__device__ __forceinline__ void exchange(float* xw, int ry, int cx, int h,
                                         const float (&t)[NI][8]) {
  __syncwarp();  // the warp's reads of the previous round are done
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) xw[(ry + 4 * i) * kXRow + cx + 8 * jj] = t[i][4 * h + jj];
  __syncwarp();
}

// rows r + 4i (below limit) of a (rows, HD) output, the lane's head dims from
// col, times mul
template <int HD, int NI>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int r, int limit, int col,
                                           float mul, const float (&acc)[NI][HD / 8]) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = r + 4 * i;
    if (row >= limit) continue;
    float* o = out + (size_t)row * HD + col;
    if constexpr (HD >= 32) {
#pragma unroll
      for (int m = 0; m < HD / 32; ++m)
        *reinterpret_cast<float4*>(o + 32 * m) =
            make_float4(acc[i][4 * m] * mul, acc[i][4 * m + 1] * mul, acc[i][4 * m + 2] * mul,
                        acc[i][4 * m + 3] * mul);
    } else {
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][0] * mul, acc[i][1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (b, h, 64 query rows), streaming K and V tiles
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(Ffma<HD, true>::THREADS, Ffma<HD, true>::MIN_BLOCKS)
flash_bwd_dq_ffma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Sq, int Sk, int causal, int q_offset,
                  float scale) {
  using F = Ffma<HD, true>;
  constexpr int ROW = F::ROW, SLAB = F::SLAB, NI = F::NI;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][ROW], resident
  float* dos = qs + SLAB;                       // [64][ROW], resident
  float* ring = dos + SLAB;                     // [kFStages][K, V][64][ROW]
  float* xbuf = ring + 2 * kFStages * SLAB;     // [WARPS][WR][kXRow]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = lane / 8, cx = lane % 8;
  // the causal blocks with the most KV tiles start first
  const int row0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kFRows;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * Sk * HD;
  const float* vb = v + bh * Sk * HD;
  int n_kv = (Sk + kFRows - 1) / kFRows;
  if (causal) {
    // KV tiles above the diagonal of this block's last live row are skipped
    const int last_key = min(row0 + kFRows - 1, Sq - 1) + q_offset;
    n_kv = last_key < 0 ? 0 : min(n_kv, last_key / kFRows + 1);
  }
  if (n_kv > 0) {  // Q, dO and the first K, V tile: one group
    stage_async<HD, F::THREADS>(qs, q + bh * Sq * HD, row0, Sq);
    stage_async<HD, F::THREADS>(dos, dout + bh * Sq * HD, row0, Sq);
    stage_async<HD, F::THREADS>(ring, kb, 0, Sk);
    stage_async<HD, F::THREADS>(ring + SLAB, vb, 0, Sk);
    cp_async_commit();
  }

  const int wrow = warp * F::WR;  // the warp's first row in the block
  const int rw = row0 + wrow;
  const float sl2 = scale * kLog2e;
  float lse2[NI], dlt[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = rw + ry + 4 * i;
    lse2[i] = row < Sq ? lse[bh * Sq + row] * kLog2e : 0.f;
    dlt[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  float acc[NI][F::DPT];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < F::DPT; ++e) acc[i][e] = 0.f;
  float* xw = xbuf + warp * F::WR * kXRow;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in for every thread; tile j - 1's stage is free
    if (j + 1 < n_kv) {
      float* next = ring + ((j + 1) % kFStages) * 2 * SLAB;
      stage_async<HD, F::THREADS>(next, kb, (j + 1) * kFRows, Sk);
      stage_async<HD, F::THREADS>(next + SLAB, vb, (j + 1) * kFRows, Sk);
      cp_async_commit();
    }
    const float* ks = ring + (j % kFStages) * 2 * SLAB;
    const float* vs = ks + SLAB;

    // s and dp for rows rw + ry + 4i and keys key0 + cx + 8jn
    float s[NI][8], dp[NI][8];
    dot_tiles<HD, NI>(qs + (wrow + ry) * ROW, ks + cx * ROW, s, dos + (wrow + ry) * ROW,
                      vs + cx * ROW, dp);
    const int key0 = j * kFRows;
    // rows past Sq only reach dq rows that are not stored; keys past Sk and
    // above the diagonal are masked
    const bool edge = key0 + kFRows > Sk || (causal && key0 + kFRows - 1 > rw + q_offset);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float p = exp2_ftz(fmaf(s[i][jn], sl2, -lse2[i]));
        if (edge) {
          const int key = key0 + cx + 8 * jn;
          if (key >= Sk || (causal && key > rw + ry + 4 * i + q_offset)) p = 0.f;
        }
        dp[i][jn] = p * (dp[i][jn] - dlt[i]);  // ds
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // dq += ds k, 32 keys at a time
      exchange<NI>(xw, ry, cx, h, dp);
      acc_tile<HD, NI>(xw + ry * kXRow, ks + h * kHalf * ROW + lane_col<HD>(cx), acc);
    }
  }
  store_tile<HD, NI>(dq + bh * Sq * HD, rw + ry, Sq, lane_col<HD>(cx), scale, acc);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (b, h, 64 keys), streaming Q, dO, lse and delta tiles
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(Ffma<HD, false>::THREADS, Ffma<HD, false>::MIN_BLOCKS)
flash_bwd_dkv_ffma(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int causal,
                   int q_offset, float scale) {
  using F = Ffma<HD, false>;
  constexpr int ROW = F::ROW, SLAB = F::SLAB, NI = F::NI;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [64][ROW], resident
  float* vs = ks + SLAB;                        // [64][ROW], resident
  // [kFStages][Q, dO][64][ROW]; row r of a staged Q tile carries lse[r] in
  // its first pad column (HD), of a dO tile delta[r]
  float* ring = vs + SLAB;
  float* xbuf = ring + 2 * kFStages * SLAB;     // [WARPS][WR][kXRow]

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int ry = lane / 8, cx = lane % 8;
  // key tile 0 sees every query tile: the heaviest causal blocks start first
  const int key0 = (int)blockIdx.x * kFRows;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * Sq * HD;
  const float* dob = dout + bh * Sq * HD;
  const float* lb = lse + bh * Sq;
  const float* db = delta + bh * Sq;
  int first = 0;
  if (causal) {
    // query tiles whose last row is still above this key tile's first
    // column see none of it: start at the first one that reaches the band
    const int first_row = key0 - q_offset;
    first = first_row <= 0 ? 0 : first_row / kFRows;
  }
  const int n_tiles = max(0, (Sq + kFRows - 1) / kFRows - first);

  const auto stage_rows = [&](float* dst, int r0) {
    stage_async<HD, F::THREADS>(dst, qb, r0, Sq);
    stage_async<HD, F::THREADS>(dst + SLAB, dob, r0, Sq);
    if (t < 2 * kFRows) {  // lse into Q's pad column, delta into dO's
      const int r = t % kFRows;
      const bool ok = r0 + r < Sq;
      const int src = ok ? r0 + r : 0;
      if (t < kFRows) cp_async4(dst + r * ROW + HD, lb + src, ok);
      else cp_async4(dst + SLAB + r * ROW + HD, db + src, ok);
    }
  };
  if (n_tiles > 0) {  // K, V and the first Q, dO tile: one group
    stage_async<HD, F::THREADS>(ks, k + bh * Sk * HD, key0, Sk);
    stage_async<HD, F::THREADS>(vs, v + bh * Sk * HD, key0, Sk);
    stage_rows(ring, first * kFRows);
    cp_async_commit();
  }

  const int wkey = warp * F::WR;  // the warp's first key in the block
  const int kw = key0 + wkey;
  const float sl2 = scale * kLog2e;
  float dk_acc[NI][F::DPT], dv_acc[NI][F::DPT];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < F::DPT; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  float* xw = xbuf + warp * F::WR * kXRow;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it is in for every thread; tile it - 1's stage is free
    if (it + 1 < n_tiles) {
      stage_rows(ring + ((it + 1) % kFStages) * 2 * SLAB, (first + it + 1) * kFRows);
      cp_async_commit();
    }
    const float* qs = ring + (it % kFStages) * 2 * SLAB;
    const float* dos = qs + SLAB;
    const int r0 = (first + it) * kFRows;

    // s^T and dp^T for keys kw + ry + 4i and query rows r0 + cx + 8jn
    float pt[NI][8], dst[NI][8];
    dot_tiles<HD, NI>(ks + (wkey + ry) * ROW, qs + cx * ROW, pt, vs + (wkey + ry) * ROW,
                      dos + cx * ROW, dst);
    // keys past Sk only reach dk, dv rows that are not stored; rows past Sq
    // and above the diagonal are masked
    const bool edge = r0 + kFRows > Sq || (causal && kw + F::WR - 1 > r0 + q_offset);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = cx + 8 * jn;
      const float l2 = qs[c * ROW + HD] * kLog2e, dl = dos[c * ROW + HD];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float p = exp2_ftz(fmaf(pt[i][jn], sl2, -l2));
        if (edge) {
          const int row = r0 + c;
          if (row >= Sq || (causal && kw + ry + 4 * i > row + q_offset)) p = 0.f;
        }
        dst[i][jn] = p * (dst[i][jn] - dl);  // ds^T
        pt[i][jn] = p;                       // p^T
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 32 query rows at a time
      exchange<NI>(xw, ry, cx, h, pt);
      acc_tile<HD, NI>(xw + ry * kXRow, dos + h * kHalf * ROW + lane_col<HD>(cx), dv_acc);
      exchange<NI>(xw, ry, cx, h, dst);
      acc_tile<HD, NI>(xw + ry * kXRow, qs + h * kHalf * ROW + lane_col<HD>(cx), dk_acc);
    }
  }
  const size_t keys = bh * Sk;
  store_tile<HD, NI>(dk + keys * HD, kw + ry, Sk, lane_col<HD>(cx), scale, dk_acc);
  store_tile<HD, NI>(dv + keys * HD, kw + ry, Sk, lane_col<HD>(cx), 1.f, dv_acc);
}

// ===========================================================================
// Tensor-core kernels: bf16 inputs (lowp, SPLIT = false; or not, SPLIT = true)
// ===========================================================================

constexpr int kRows = 64;                 // rows of a block's resident tile: one wgmma M
constexpr int kStages = 2;                // ring of streamed tiles (3 and 4 were no faster)
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr uint32_t kSlab = 64 * 128;      // bytes of [64 rows][64 bf16], 128-byte rows
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
  using F = Ffma<HD, DQ>;
  const float *q = (const float*)a.q, *k = (const float*)a.k, *v = (const float*)a.v,
              *dout = (const float*)a.dout, *lse = (const float*)a.lse,
              *delta = (const float*)a.delta;
  // the whole shared-memory carveout, so that two blocks fit an SM
  const auto prepare = [](auto kernel) {
    const cudaError_t err = set_smem(kernel, F::SMEM);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  };
  if constexpr (DQ) {
    auto kernel = flash_bwd_dq_ffma<HD>;
    const cudaError_t err = prepare(kernel);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kFRows - 1) / kFRows, a.BH);
    kernel<<<grid, F::THREADS, F::SMEM, a.stream>>>(q, k, v, dout, lse, delta, (float*)a.out0,
                                                   a.Sq, a.Sk, a.causal, a.q_offset, a.scale);
  } else {
    auto kernel = flash_bwd_dkv_ffma<HD>;
    const cudaError_t err = prepare(kernel);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kFRows - 1) / kFRows, a.BH);
    kernel<<<grid, F::THREADS, F::SMEM, a.stream>>>(q, k, v, dout, lse, delta, (float*)a.out0,
                                                   (float*)a.out1, a.Sq, a.Sk, a.causal,
                                                   a.q_offset, a.scale);
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  // lowp with f32 inputs is rounded to bf16 by the caller
  if (!is_bf16 && lowp) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Every grid puts b*h on grid.y, whose limit is 65535: a larger B*H runs
  // in chunks of heads, each with its base pointers advanced (and, for the
  // tensor-core kernels, its tensor maps encoded over the chunk), so the
  // kernel bodies are the same code for any B*H.
  const size_t elt = is_bf16 ? 2 : 4;
  const int BH = B * H;
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridY) {
    const int n = BH - bh0 < kMaxGridY ? BH - bh0 : kMaxGridY;
    const size_t rq = (size_t)bh0 * Sq, rk = (size_t)bh0 * Sk;  // rows before the chunk
    const auto in = [&](const void* p, size_t rows) {
      return (const void*)((const char*)p + rows * hd * elt);
    };
    const auto out = [&](void* p, size_t rows) {
      return p ? (void*)((float*)p + rows * hd) : nullptr;
    };
    const Args a{in(q, rq), in(k, rk), in(v, rk), in(dout, rq),
                 (const float*)lse + rq, (const float*)delta + rq,
                 out(out0, DQ ? rq : rk), out(out1, rk), n, Sq, Sk, hd, causal,
                 q_offset, scale, (cudaStream_t)stream};
    err = is_bf16 ? dispatch_tc<DQ>(a, lowp == 0) : dispatch_ffma<DQ>(a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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
