// Latent-space MLA decode for Hopper (sm_90a), over a contiguous or a paged
// latent cache.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _decode_kernel (flash_decode) and _decode_paged_kernel (flash_decode_paged)
// in the geometry src/repro/kernels/ops.py::decode_attention_mla{,_paged}
// runs them in: one KV head (K = 1) shared by all G = H query rows, keys
// [latent | k_rope] (hd = r + rd, 576 at deepseek-v3's r 512 and rd 64),
// values the latent itself (hdv = r, 512), and an explicit softmax scale
// (1/sqrt(nope + rope), 1/sqrt(192), not 1/sqrt(576)). For each sequence b
// and query row h:
//
//   s = scale * (q_lat[b,h] . latent[b,p] + q_rope[b,h] . k_rope[b,p])
//   for positions p < min(lengths[b], capacity), ctx[b,h] = softmax(s) . latent
//
// A row of length 0 returns zeros; a length past the capacity reads it all
// (an idle serving slot retired at max_seq decodes with max_seq + 1). q is
// f32, as the reference casts it (src/repro/models/attention.py:672-678); the
// cache is f32 or bf16 (TKV), staged in its own type and upcast in registers.
// Under lowp q * scale, the keys, the values and p are rounded to bf16 at the
// reference's points, l summing the unrounded p.
//
// The reference concatenates [latent | k_rope] into a copy of the whole cache
// every call (ops.py:90-91: 37.7 MB a layer a step at B 8, Smax 4096 in
// bf16). This kernel reads latent and k_rope in place, as two tensors,
// staging each position's latent row and k_rope row side by side into one
// key row in shared memory; the value row is the first r elements of that
// same staged row, so one read of the cache serves both products.
//
// The address map is a template parameter: contiguous rows b * Smax + p of
// the (B,Smax,r) and (B,Smax,rd) caches (capacity Smax, read as a table of
// ceil(Smax / 64) blocks of 64 positions), or pool rows table[b, min(p / bs,
// T - 1)] * bs + p % bs of the (NB,bs,r) and (NB,bs,rd) pools (capacity
// T * bs), the entry clamped to [0, NB - 1] as the reference clips the table.
//
// What bounds it on the H100: operations. Every cached position read (r + rd
// elements, 1152 bytes in bf16) feeds 2 * H * (r + rd + r) = 2 * 128 * 1088
// FLOPs, about 240 a byte: far above f32 CUDA-core balance (20 FLOPs a byte),
// so the kernel is bound by FFMA throughput, 67 TFLOP/s. (wgmma with a bf16
// q would lift that bound; this first kernel stays in f32 FMAs.)
//
// What the design does about it:
//  - A block takes a row group of 32 of the H query rows (q in shared memory
//    as f32, 32 x 576 x 4 = 73.7 KB) and one split of the row's positions.
//    The grid is 1-D over (split, row group, b); splits are ranges of `bps`
//    whole table entries (kernels/flash_attention.py::decode_mla_plan, from
//    T, bs, B * ceil(H / 32) and the SM count). H / 32 row groups read the
//    same positions: the cache is read ceil(H / 32) times (4 at H 128), from
//    L2 where the blocks of one split run together.
//  - Positions are staged in chunks of 32 (bf16) or 16 (f32) key rows of
//    r + rd elements (75 KB a stage either way), through a 2-stage cp.async
//    ring; the next chunk's copies are issued after the chunk's last barrier,
//    so they overlap its arithmetic. 152 KB of shared memory in all: one
//    block an SM.
//  - Scores: warp w takes rows 4w..4w+3, lane (key, part) a key of the chunk
//    (bf16: one lane a key; f32: two lanes a key, halves of its dims joined by
//    one shuffle), reading its key row 16 bytes at a time (rows padded by 16
//    bytes, so the 8 lanes of a quarter warp hit different banks) against
//    the rows' q (broadcast). Each warp keeps its rows' online softmax (max
//    and sum over the chunk's keys by shuffles; p = 2^(s log2 e - m log2 e),
//    one FMA and one ex2.approx) and writes p and the correction to shared
//    memory.
//  - P V: thread (rows 8i..8i+7, dims 8j..8j+7) keeps a 64-float slice of the
//    32 x r accumulator, reading 8 value elements (16 bytes of bf16) and the
//    8 rows' p (two float4 broadcasts) a key: 64 FMAs for 3 shared loads.
//  - With one split the block writes ctx; with more it writes its f32 partial
//    (m, l and the unnormalised acc) to a workspace the wrapper allocates,
//    and the last live block of its (b, row group) to arrive (an atomic count
//    it resets itself, B * ceil(H / 32) ints the wrapper keeps zero, shared
//    with the other decode kernels) merges the live splits in split order.
//    Nothing syncs the host, and two calls give the same bits.
//
// Layout: q_lat (B,H,r) and q_rope (B,H,rd) f32; latent (B,Smax,r) and
// k_rope (B,Smax,rd), or pools (NB,bs,r) and (NB,bs,rd), one dtype; table
// (B,T) int32, lengths (B,) int32; out (B,H,r) f32; all contiguous, r and rd
// multiples of 8, r <= 512; the workspace ws_ml (B * ceil(H/32), splits, 32,
// 2) and ws_acc (B * ceil(H/32), splits, 32, r) f32. The kernels allocate
// nothing and launch on the caller's stream. This file is self-contained (no
// shared header), so the build's hash of it covers everything it compiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>
#include <stdio.h>  // snprintf

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                   // query rows of a block (a row group)
constexpr int kWarpRows = kRows / kWarps;   // rows of scores a warp takes
constexpr int kPvRows = 8;                  // accumulator rows a thread holds
constexpr int kPvDims = 8;                  // accumulator dims a thread holds
constexpr int kDimGroups = kThreads / (kRows / kPvRows);  // 64: r <= 512
constexpr int kMaxLatent = kDimGroups * kPvDims;
constexpr int kStages = 2;
constexpr int kVirtualBlock = 64;  // positions of a contiguous cache's table entry
constexpr int kMaxSmem = 232448 - 64;  // a block's bytes, less this kernel's static ones

// key rows a stage holds: 75 KB of staged rows at r + rd = 576 either way
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kKeys = 32;
};
template <>
struct Tile<float> {
  static constexpr int kKeys = 16;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// a dot input: bf16-rounded under lowp, else as is
template <bool LOWP>
__device__ __forceinline__ float dot_in(float x) {
  if constexpr (LOWP) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// 16 bytes of shared memory as floats: 8 bf16 or 4 f32 elements
template <bool LOWP>
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = dot_in<LOWP>(f.x);
    x[2 * i + 1] = dot_in<LOWP>(f.y);
  }
}
template <bool LOWP>
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = dot_in<LOWP>(f.x);
  x[1] = dot_in<LOWP>(f.y);
  x[2] = dot_in<LOWP>(f.z);
  x[3] = dot_in<LOWP>(f.w);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (a p that small changes no f32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// all but the most recent group of copies have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// copy cw bytes (16, 8, 4 or 2; both addresses aligned to it) from device
// to shared memory: cp.async for 4 and up, a plain load and store for 2
__device__ __forceinline__ void copy_piece(void* dst, const void* src, int cw) {
  switch (cw) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)), "l"(src)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
                   : "memory");
      break;
    default:
      *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

// Copy rows [0, n) of a chunk, units pieces of cw bytes each: row i from
// src + prow[i] * stride, to dst + i * pitch.
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, const uint8_t* src,
                                          size_t stride, const int* prow, int n, int units,
                                          int cw, int t) {
  for (int u = t; u < n * units; u += kThreads) {
    const int i = u / units, off = (u - i * units) * cw;
    copy_piece(dst + i * pitch + off, src + (size_t)prow[i] * stride + off, cw);
  }
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of a split block: the row group's scaled queries (f32), two
// stages of `keys` key rows [latent | k_rope] (padded by 16 bytes), the
// chunk's p [keys][kRows] and the rows' corrections, final m and l, each
// stage's cache rows, then the block's table entries.
struct Layout {
  int kp;     // bytes of a staged key row
  int stage;  // bytes of a stage
  int stages_off, p_off, stat_off, prow_off, tbl_off, total;
  __host__ __device__ Layout(int r, int rd, int bps, int elt, int keys)
      : kp(round16((r + rd) * elt) + 16), stage(keys * kp), stages_off(kRows * (r + rd) * 4),
        p_off(0), stat_off(0), prow_off(0), tbl_off(0), total(0) {
    p_off = stages_off + kStages * stage;
    stat_off = p_off + keys * kRows * 4;
    prow_off = stat_off + 3 * kRows * 4;
    tbl_off = prow_off + kStages * keys * 4;
    total = tbl_off + bps * 4;
  }
};

// Block (split, row group, b): the online softmax of its 32 query rows over
// its range of positions, written as ctx (splits == 1) or as an f32 partial
// (m, l, acc) of the workspace. lcw, rcw: the copy widths in bytes of latent
// and k_rope rows. PAGED: latent and k_rope are pools read through the table,
// n_cache = NB pool blocks; else the contiguous caches, n_cache = Smax,
// bs = kVirtualBlock and nT = ceil(Smax / kVirtualBlock) (no table).
template <typename TKV, bool LOWP, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_mla_split(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                       const TKV* __restrict__ latent, const TKV* __restrict__ k_rope,
                       const int* __restrict__ table, const int* __restrict__ lengths,
                       float* __restrict__ out, float* __restrict__ ws_ml,
                       float* __restrict__ ws_acc, int* __restrict__ arrivals, int H,
                       int n_cache, int bs, int nT, int r, int rd, float scale, int splits,
                       int bps, int lcw, int rcw) {
  constexpr int KT = Tile<TKV>::kKeys;
  constexpr int DP = 32 / KT;                       // lanes on one key's dims
  constexpr int VEC = 16 / (int)sizeof(TKV);        // elements of a 16-byte load
  const int qp = r + rd;                            // a key row's elements
  const int elt = (int)sizeof(TKV);
  const Layout lay(r, rd, PAGED ? bps : 0, elt, KT);
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(sm);                      // [kRows][qp]
  uint8_t* stages = sm + lay.stages_off;                         // [kStages][KT][kp]
  float* pt = reinterpret_cast<float*>(sm + lay.p_off);          // [KT][kRows]
  float* corr_s = reinterpret_cast<float*>(sm + lay.stat_off);   // [kRows]
  float* m_s = corr_s + kRows;                                   // [kRows]
  float* l_s = m_s + kRows;                                      // [kRows]
  int* prow = reinterpret_cast<int*>(sm + lay.prow_off);         // [kStages][KT]
  int* tbl = reinterpret_cast<int*>(sm + lay.tbl_off);           // [bps]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_rg = (H + kRows - 1) / kRows;
  unsigned idx = blockIdx.x;
  const int split = (int)(idx % (unsigned)splits);
  idx /= (unsigned)splits;
  const int rg = (int)(idx % (unsigned)n_rg);
  const int b = (int)(idx / (unsigned)n_rg);
  const int bk = b * n_rg + rg;  // the block's (b, row group)
  const int cap = PAGED ? nT * bs : n_cache;
  const int len = min(max(lengths[b], 0), cap);
  const int p0 = split * bps * bs, p1 = min(p0 + bps * bs, len);
  const int g0 = rg * kRows, gn = min(kRows, H - g0);
  const size_t row0 = (size_t)b * H + g0;  // the block's first query row
  for (int i = t; i < kRows * qp; i += kThreads) {
    const int row = i / qp, d = i - row * qp;
    float x = 0.f;
    if (row < gn)
      x = d < r ? q_lat[(row0 + row) * r + d] : q_rope[(row0 + row) * rd + (d - r)];
    qs[i] = dot_in<LOWP>(x * scale);
  }
  const int first = split * bps;  // the block's first table entry
  if constexpr (PAGED) {
    const int n_tbl = min(bps, nT - first);
    for (int i = t; i < n_tbl; i += kThreads)
      tbl[i] = min(max(table[(size_t)b * nT + first + i], 0), n_cache - 1);
  }
  if (p0 >= p1) {
    if (split == 0)  // a row of length 0 returns zeros
      for (int i = t; i < gn * r; i += kThreads) out[row0 * r + i] = 0.f;
    return;
  }
  __syncthreads();

  const int n_chunks = (p1 - p0 + KT - 1) / KT;
  const size_t lat_row = (size_t)r * elt, rope_row = (size_t)rd * elt;  // bytes of a cache row
  // paged: the pools' rows; contiguous: sequence b's
  const size_t seq = PAGED ? 0 : (size_t)b * n_cache;
  const uint8_t* lb = reinterpret_cast<const uint8_t*>(latent) + seq * lat_row;
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(k_rope) + seq * rope_row;

  // the cache row of each position of chunk c, into its stage's prow
  const auto translate = [&](int c) {
    const int c0 = p0 + c * KT;
    if (t < min(KT, p1 - c0)) {
      const int pos = c0 + t;
      if constexpr (PAGED) {
        const int j = pos / bs;
        prow[(c % kStages) * KT + t] = tbl[j - first] * bs + (pos - j * bs);
      } else {
        prow[(c % kStages) * KT + t] = pos;
      }
    }
  };
  // issue the copies of chunk c into its stage, as one group: each position's
  // latent row, then its k_rope row right after it
  const auto issue = [&](int c) {
    const int n = min(KT, p1 - (p0 + c * KT)), st = c % kStages;
    uint8_t* dst = stages + st * lay.stage;
    const int* pr = prow + st * KT;
    copy_rows(dst, lay.kp, lb, lat_row, pr, n, (int)lat_row / lcw, lcw, t);
    copy_rows(dst + lat_row, lay.kp, rb, rope_row, pr, n, (int)rope_row / rcw, rcw, t);
    cp_async_commit();
  };

  float m[kWarpRows], l[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[kPvRows][kPvDims];
#pragma unroll
  for (int i = 0; i < kPvRows; ++i)
#pragma unroll
    for (int j = 0; j < kPvDims; ++j) acc[i][j] = 0.f;
  const int pv_rg = t / kDimGroups;           // accumulator rows 8 pv_rg ..
  const int pv_dg = t - pv_rg * kDimGroups;   // accumulator dims 8 pv_dg ..
  const bool pv_live = pv_dg * kPvDims < r;
  const int key = lane % KT, part = lane / KT;
  const float* qw = qs + warp * kWarpRows * qp;  // the warp's score rows

  // both stages' copies in flight from the start; chunk c + 2 is issued as
  // soon as every thread is done with chunk c
  translate(0);
  if (n_chunks > 1) translate(1);
  __syncthreads();
  issue(0);
  if (n_chunks > 1) issue(1);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) cp_async_wait_one();
    else cp_async_wait_all();
    __syncthreads();  // chunk c is in for every thread; the last chunk's p is read
    const int nk = min(KT, p1 - (p0 + c * KT));  // the chunk's positions
    const uint8_t* st = stages + (c % kStages) * lay.stage;

    // s = (q * scale) . [latent | k_rope] of the lane's key, over its dims
    const TKV* kr = reinterpret_cast<const TKV*>(st + key * lay.kp);
    float s[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int d = VEC * part; d < qp; d += VEC * DP) {
      float kv[VEC];
      load16<LOWP>(kr + d, kv);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * qp + d + e);
          s[i] = fmaf(qv.x, kv[e], s[i]);
          s[i] = fmaf(qv.y, kv[e + 1], s[i]);
          s[i] = fmaf(qv.z, kv[e + 2], s[i]);
          s[i] = fmaf(qv.w, kv[e + 3], s[i]);
        }
      }
    }
    const bool valid = key < nk;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float sv = s[i];
      if constexpr (DP == 2) sv += __shfl_xor_sync(kFull, sv, 16);
      sv = valid ? sv : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int o = KT / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float corr = exp2_ftz((m[i] - mn) * kLog2e);
      const float p = exp2_ftz(fmaf(sv, kLog2e, -mn * kLog2e));  // masked: 2^-inf = 0
      float sum = p;
#pragma unroll
      for (int o = KT / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = mn;
      if (part == 0) pt[key * kRows + warp * kWarpRows + i] = dot_in<LOWP>(p);
      if (lane == 0) corr_s[warp * kWarpRows + i] = corr;
    }
    __syncthreads();  // the chunk's p and corrections are in

    // acc = acc * corr + p V, the values being the staged latent rows
    if (pv_live) {
      const float4 ca = *reinterpret_cast<const float4*>(corr_s + pv_rg * kPvRows);
      const float4 cb = *reinterpret_cast<const float4*>(corr_s + pv_rg * kPvRows + 4);
      const float cr[kPvRows] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
      for (int i = 0; i < kPvRows; ++i)
#pragma unroll
        for (int j = 0; j < kPvDims; ++j) acc[i][j] *= cr[i];
      const TKV* vcol = reinterpret_cast<const TKV*>(st) + pv_dg * kPvDims;
      for (int kk = 0; kk < nk; ++kk) {  // in key order
        const TKV* vr = reinterpret_cast<const TKV*>(
            reinterpret_cast<const uint8_t*>(vcol) + kk * lay.kp);
        float v[kPvDims];
#pragma unroll
        for (int j = 0; j < kPvDims; j += VEC) load16<LOWP>(vr + j, v + j);
        const float4 pa = *reinterpret_cast<const float4*>(pt + kk * kRows + pv_rg * kPvRows);
        const float4 pb =
            *reinterpret_cast<const float4*>(pt + kk * kRows + pv_rg * kPvRows + 4);
        const float pk[kPvRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int i = 0; i < kPvRows; ++i)
#pragma unroll
          for (int j = 0; j < kPvDims; ++j) acc[i][j] = fmaf(pk[i], v[j], acc[i][j]);
      }
    }
    if (c + 2 < n_chunks) {
      translate(c + 2);
      __syncthreads();  // every thread is done with chunk c's stage
      issue(c + 2);
    }
  }

  // the score warps' m and l beside the accumulator's threads
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      m_s[warp * kWarpRows + i] = m[i];
      l_s[warp * kWarpRows + i] = l[i];
    }
  }
  __syncthreads();
  if (pv_live) {
#pragma unroll
    for (int i = 0; i < kPvRows; ++i) {
      const int row = pv_rg * kPvRows + i;
      if (row >= gn) continue;
      const int d0 = pv_dg * kPvDims;
      if (splits == 1) {
        const float lr = fmaxf(l_s[row], 1e-30f);
#pragma unroll
        for (int j = 0; j < kPvDims; ++j) out[(row0 + row) * r + d0 + j] = acc[i][j] / lr;
      } else {
        const size_t wrow = ((size_t)bk * splits + split) * kRows + row;  // partial row
#pragma unroll
        for (int j = 0; j < kPvDims; ++j) ws_acc[wrow * r + d0 + j] = acc[i][j];
        if (pv_dg == 0) {
          ws_ml[2 * wrow] = m_s[row];
          ws_ml[2 * wrow + 1] = l_s[row];
        }
      }
    }
  }
  if (splits == 1) return;

  // The last of the (b, row group)'s live blocks to arrive merges their
  // partials in split order (the threadFenceReduction pattern: each block's
  // partial is visible device-wide before its arrival counts) and resets the
  // count.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int live = (len + bps * bs - 1) / (bps * bs);
  if (t == 0) {
    int* count = arrivals + bk;
    last = atomicAdd(count, 1) == live - 1;
    if (last) *count = 0;  // every live block has arrived: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < gn * r; i += kThreads) {
    const int row = i / r, d = i - row * r;
    const size_t base = (size_t)bk * splits * kRows + row;  // its partial of split s: + s kRows
    float mx = kNegInf;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, __ldcg(ws_ml + 2 * (base + (size_t)s * kRows)));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t wrow = base + (size_t)s * kRows;
      const float c = exp2_ftz((__ldcg(ws_ml + 2 * wrow) - mx) * kLog2e);
      lsum = fmaf(__ldcg(ws_ml + 2 * wrow + 1), c, lsum);
      a = fmaf(__ldcg(ws_acc + wrow * r + d), c, a);
    }
    out[(row0 + row) * r + d] = a / fmaxf(lsum, 1e-30f);
  }
}

struct Args {
  const float *q_lat, *q_rope;
  const void *latent, *k_rope;
  const int *table, *lengths;
  float* out;
  float *ws_ml, *ws_acc;
  int* arrivals;
  int B, H, NB, Smax, bs, nT, r, rd;
  float scale;
  int splits, bps;
  cudaStream_t stream;
};

// the widest copy (16, 8, 4 or 2 bytes) that rows of row_bytes at base allow,
// landing at offset dst_off of a 16-byte aligned staged row
int copy_width(const void* base, int row_bytes, int dst_off) {
  const unsigned long long a =
      (unsigned long long)base | (unsigned long long)row_bytes | (unsigned long long)dst_off;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

template <typename TKV>
int tile_keys() {
  return Tile<TKV>::kKeys;
}

template <typename TKV, bool LOWP, bool PAGED>
cudaError_t launch(const Args& a) {
  const int elt = (int)sizeof(TKV);
  const Layout lay(a.r, a.rd, PAGED ? a.bps : 0, elt, Tile<TKV>::kKeys);
  auto kernel = flash_decode_mla_split<TKV, LOWP, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         lay.total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.B * ((a.H + kRows - 1) / kRows) * a.splits;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, lay.total, a.stream>>>(
      a.q_lat, a.q_rope, (const TKV*)a.latent, (const TKV*)a.k_rope, a.table, a.lengths, a.out,
      a.ws_ml, a.ws_acc, a.arrivals, a.H, PAGED ? a.NB : a.Smax, a.bs, a.nT, a.r, a.rd, a.scale,
      a.splits, a.bps, copy_width(a.latent, a.r * elt, 0),
      copy_width(a.k_rope, a.rd * elt, a.r * elt));
  return cudaGetLastError();
}

template <typename TKV, bool PAGED>
cudaError_t launch_lowp(const Args& a, int lowp) {
  return lowp ? launch<TKV, true, PAGED>(a) : launch<TKV, false, PAGED>(a);
}

template <bool PAGED>
int run(const Args& a, int kv_bf16, int lowp, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int elt = kv_bf16 ? 2 : 4;
  const int keys = kv_bf16 ? tile_keys<__nv_bfloat16>() : tile_keys<float>();
  if (a.r < 8 || a.r % 8 != 0 || a.r > kMaxLatent || a.rd < 8 || a.rd % 8 != 0 || a.H < 1 ||
      a.bs < 1 || a.nT < 1 || (PAGED ? a.NB < 1 : a.Smax < 1) || a.splits < 1 || a.bps < 1 ||
      (long long)a.splits * a.bps < a.nT || (long long)(a.splits - 1) * a.bps >= a.nT ||
      (a.splits > 1 && (a.ws_ml == nullptr || a.ws_acc == nullptr || a.arrivals == nullptr)) ||
      Layout(a.r, a.rd, PAGED ? a.bps : 0, elt, keys).total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)(kv_bf16 ? launch_lowp<__nv_bfloat16, PAGED>(a, lowp)
                       : launch_lowp<float, PAGED>(a, lowp));
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take. splits
// blocks of bps table entries each (pool blocks, or 64-position blocks of the
// contiguous cache) cover a row (splits * bps >= the row's entries); with
// splits > 1, ws_ml and ws_acc hold (B * ceil(H/32), splits, 32, 2) and
// (B * ceil(H/32), splits, 32, r) floats, and arrivals B * ceil(H/32) ints
// that are zero (each call leaves them so). kv_bf16: the cache in bf16 (f32
// otherwise); q and out are f32.
int flash_decode_mla(const void* q_lat, const void* q_rope, const void* latent,
                     const void* k_rope, const void* lengths, void* out, void* ws_ml,
                     void* ws_acc, void* arrivals, int B, int H, int Smax, int r, int rd,
                     float scale, int splits, int bps, int kv_bf16, int lowp, int device,
                     void* stream) {
  const Args a{(const float*)q_lat, (const float*)q_rope, latent, k_rope, nullptr,
               (const int*)lengths, (float*)out, (float*)ws_ml, (float*)ws_acc, (int*)arrivals,
               B, H, 0, Smax, kVirtualBlock,
               Smax < 1 ? 0 : (Smax + kVirtualBlock - 1) / kVirtualBlock, r, rd, scale, splits,
               bps, (cudaStream_t)stream};
  return run<false>(a, kv_bf16, lowp, device);
}

int flash_decode_mla_paged(const void* q_lat, const void* q_rope, const void* latent_pool,
                           const void* k_rope_pool, const void* table, const void* lengths,
                           void* out, void* ws_ml, void* ws_acc, void* arrivals, int B, int H,
                           int NB, int bs, int nT, int r, int rd, float scale, int splits,
                           int bps, int kv_bf16, int lowp, int device, void* stream) {
  const Args a{(const float*)q_lat, (const float*)q_rope, latent_pool, k_rope_pool,
               (const int*)table, (const int*)lengths, (float*)out, (float*)ws_ml,
               (float*)ws_acc, (int*)arrivals, B, H, NB, 0, bs, nT, r, rd, scale, splits, bps,
               (cudaStream_t)stream};
  return run<true>(a, kv_bf16, lowp, device);
}

// The error's name; for an argument the entry points refuse, the geometry
// they take as well (the one place these limits are stated).
const char* kernel_error_string(int code) {
  static char refused[256];
  if (code != (int)cudaErrorInvalidValue) return cudaGetErrorString((cudaError_t)code);
  snprintf(refused, sizeof refused,
           "%s: flash_decode_mla takes a latent r and a rope rd that are multiples of 8, "
           "8 <= r <= %d, rd >= 8, and at most %d bytes of shared memory a block",
           cudaGetErrorString(cudaErrorInvalidValue), kMaxLatent, kMaxSmem);
  return refused;
}

}  // extern "C"
