// Speculative multi-token verify for Hopper (sm_90a), over a contiguous or a
// paged KV cache.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _spec_decode_kernel (flash_decode_spec) and _spec_decode_paged_kernel
// (flash_decode_spec_paged): _decode_kernel's math grown to a query block of
// S draft positions x G grouped heads, flattened to R = S*G rows with
// r = qi*G + g. lengths[b] is the BASE count, before the S draft KVs were
// written at positions base..base+S-1, so row r attends positions
// < min(base + qi + 1, capacity): the causal mask inside the window is per
// row. Capacity is Smax for the contiguous cache and T*bs for the paged one
// (an idle serving slot has base = max_seq; nothing past the buffer or the
// table is read). Every row attends position 0, so no row is empty. Under
// lowp q * scale, k, v and p are rounded to bf16 at the reference's points,
// l summing the unrounded p.
//
// The address map is a template parameter: contiguous row b*Smax + p of the
// (B,Smax,K,hd) cache, or pool row table[b, p/bs]*bs + p%bs of the
// (NB,bs,K,hd) pool, the table entry clamped to [0, NB-1].
//
// What bounds it on the H100: the bytes of the live cache, read once for all
// R rows of a (b, kv head). Each element read feeds 2 R FLOPs (40 at the
// serve shape, S 5 x G 4), below f32 CUDA-core balance; at the serve shape
// (B8 K8 hd64, 3,783 live positions) the cache is 15.5 MB, 0.0048 ms at
// 3.35 TB/s, so fixed latencies and the split's grid decide the time.
//
// What the design does about it: csrc/flash_decode_paged.cu's split of the
// keys across blocks, with the verify rows of a (b, kv head) in one block.
//  - The grid is 1-D over (split, row block, kv head, b). A split is a range
//    of `bps` whole pool blocks (paged) or 64-position chunks (contiguous:
//    the cache read as a table of 64-position blocks), from the wrapper's
//    plan (kernels/flash_attention.py::spec_plan, decode_paged_plan over
//    B*K*row blocks and the SM count). A row block is up to 24 rows, so
//    each row block reads its keys once; R past 24 takes several row blocks,
//    which read the split again from L2. A block whose range starts at or
//    past its row block's last limit returns at once.
//  - A block stages its positions' K and V rows in chunks of up to 64
//    positions (whole pool blocks where bs <= 64) through a 2-stage ring of
//    cp.async copies, 16 bytes each where the rows allow it. Each chunk's
//    cache rows are translated by the threads of its positions, their table
//    entries loading while the chunk two before is computed, so shared
//    memory grows with neither R nor T.
//  - 12 warps: 4 key slices x 3 row parts. Warp (part, slice) takes keys
//    slice * 16 .. + 15 of every chunk for the row groups part, part + 3,
//    ... (4 rows a group), and keeps their (m, l, acc) in registers for the
//    whole split: lane (key, half) sums half of the head dims of q.k, one
//    shuffle joins the halves, and each row's online softmax takes its max
//    and sum over the slice's 16 lanes, the rows' reductions interleaved
//    (p = 2^(s log2 e - m log2 e) as one FMA and one ex2.approx), masked per
//    row only in the chunk that reaches past the warp's first limit. P V:
//    the warp's p goes to shared memory, 4 rows a store; each lane owns
//    value dims lane + 32 j and reads p 4 rows at a time as a broadcast.
//    Splitting rows across warps keeps a thread at 80 registers, so two
//    blocks (24 warps) share an SM: a thread holding all 24 rows needed 234
//    and ran 8 warps an SM, 1.5x slower.
//  - The key slices' (m, l, acc) merge in shared memory at the end (the
//    ring reused). With one split the block writes o; with more it writes
//    its f32 partial (m, l and the unnormalised acc) to a workspace the
//    wrapper allocates, and the last live block of its row block to arrive
//    (an atomic count it resets itself) merges the live splits in order:
//    each row's (m, l) over the splits in one pass, a warp a row, then acc.
//    Nothing syncs the host, and two calls give the same bits.
//  - What holds it back: the chunk arithmetic, not the copies (at the serve
//    shape the kernel without its copies takes 0.035 ms, without its
//    arithmetic 0.029; PERF.md). A lane reads q as float4 broadcasts, 4 for
//    every 16 FMAs of q.k, so shared-memory wavefronts set the pace.
//  - Shared memory at hd 64 f32: 2 stages of 64 x (272 + 256) bytes, 6 KB of
//    queries, 6 KB of p, the row limits and each stage's cache rows:
//    80.5 KB, two blocks an SM.
//
// Layout: q (B,K,S,G,hd), k (B,Smax,K,hd) or (NB,bs,K,hd), v likewise with
// hdv, out (B,K,S,G,hdv), all contiguous, hd a multiple of 4, hdv <= 128;
// q and out f32 or bf16 (TQ), the cache f32 or bf16 (TKV) independently,
// staged in its own type and upcast in registers as the reference casts
// them inside its kernel; lengths (B,) int32; table (B,T) int32; the workspace ws
// (B*K*row blocks, splits, 24, 2 + hdv) f32 and arrivals B*K*row blocks
// int32. The kernels allocate nothing and launch on the caller's stream.
// This file is self-contained (no shared header), so the build's hash of it
// covers everything it compiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlices = 4;   // warps along a chunk's keys
constexpr int kParts = 3;    // warps along a row block's rows (its row parts)
constexpr int kWarps = kSlices * kParts;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 24;                    // rows of a block (a row block)
constexpr int kWarpRows = kRows / kParts;   // rows a warp keeps in registers
constexpr int kGroup = 4;                    // rows a warp scores together
constexpr int kChunk = 64;                   // positions a stage holds
constexpr int kWarpKeys = kChunk / kSlices;  // keys of a chunk each warp takes
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// value dims a lane holds, in 32s
__host__ __device__ constexpr int value_regs(int hdv) { return hdv <= 32 ? 1 : hdv <= 64 ? 2 : 4; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// a dot input: bf16-rounded under lowp, else as is
template <bool LOWP>
__device__ __forceinline__ float dot_in(float x) {
  if constexpr (LOWP) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
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

// Copy rows [0, n) of a staged chunk, units pieces of cw bytes each: row r
// from src + prow[r] * stride, to dst + r * pitch. Thread t takes piece
// t % units of rows t / units, t / units + kThreads / units, ...: no
// division a piece.
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, const uint8_t* src,
                                          size_t stride, const int* prow, int n, int units,
                                          int cw, int t) {
  if (units <= kThreads) {
    const int rpp = kThreads / units, r0 = t / units, off = (t - r0 * units) * cw;
    if (r0 >= rpp) return;
    for (int r = r0; r < n; r += rpp)
      copy_piece(dst + r * pitch + off, src + (size_t)prow[r] * stride + off, cw);
  } else {  // rows wider than a piece a thread
    for (int u = t; u < n * units; u += kThreads) {
      const int r = u / units, off = (u - r * units) * cw;
      copy_piece(dst + r * pitch + off, src + (size_t)prow[r] * stride + off, cw);
    }
  }
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of a split block: the row block's scaled queries (f32), two
// stages of kChunk K rows (padded by 16 bytes so that the lanes of a warp
// hit different banks) and kChunk V rows, each warp's p of its keys for
// P V, the rows' causal limits, then each stage's cache rows. The key
// slices' merge reuses the stages.
struct Layout {
  int kp, vp;  // bytes of a staged K row, V row
  int stage;   // bytes of a stage
  int q_bytes, p_off, lim_off, prow_off, total;
  __host__ __device__ Layout(int hd, int hdv, int elt)
      : kp(round16(hd * elt) + 16), vp(round16(hdv * elt)), stage(kChunk * (kp + vp)),
        q_bytes(kRows * hd * 4), p_off(0), lim_off(0), prow_off(0), total(0) {
    int stages = kStages * stage;
    const int merge = kSlices * kRows * (hdv + 2) * 4;
    if (merge > stages) stages = merge;
    p_off = q_bytes + stages;
    lim_off = p_off + kWarps * kWarpKeys * kWarpRows * 4;
    prow_off = lim_off + kRows * 4;
    total = prow_off + kStages * kChunk * 4;
  }
};

// the block row of row r of a warp of row part rp: its groups are rp,
// rp + kParts, ...
__device__ __forceinline__ int row_of_warp(int r, int rp) {
  return (r / kGroup * kParts + rp) * kGroup + r % kGroup;
}

// positions a chunk holds: whole pool blocks where bs <= kChunk
__host__ __device__ inline int chunk_positions(int bs) {
  return bs <= kChunk ? (kChunk / bs) * bs : kChunk;
}

// Block (split, row block, kv head, b): the online softmax of its rows over
// its range of positions, written as o (splits == 1) or as an f32 partial
// (m, l, acc) of the workspace. Warp (row part, slice) takes keys
// slice * 16 .. + 15 of every chunk for the row groups part, part + kParts,
// ... (4 rows a group) of the block. JV = value dims a lane holds in 32s (hdv <= 32 JV);
// kcw and vcw are the copy widths in bytes of K and V rows.
template <typename TQ, typename TKV, int JV, bool LOWP, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_spec_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ table,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ arrivals, int K, int S, int G,
                        int Smax, int NB, int bs, int nT, int hd, int hdv, float scale,
                        int splits, int bps, int kcw, int vcw) {
  constexpr int RW = kWarpRows;
  const Layout lay(hd, hdv, (int)sizeof(TKV));
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(sm);               // [kRows][hd]
  uint8_t* stages = sm + lay.q_bytes;                     // [kStages][kChunk K rows, kChunk V rows]
  float* pw = reinterpret_cast<float*>(sm + lay.p_off);   // [kWarps][kWarpKeys][RW] p for P V
  int* lim = reinterpret_cast<int*>(sm + lay.lim_off);    // [kRows] each row's causal limit
  int* prow = reinterpret_cast<int*>(sm + lay.prow_off);  // [kStages][kChunk] cache rows

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slice = warp % kSlices, rp = warp / kSlices;  // the warp's keys, row part
  const int R = S * G, n_rb = (R + kRows - 1) / kRows;
  unsigned idx = blockIdx.x;
  const int split = (int)(idx % (unsigned)splits);
  idx /= (unsigned)splits;
  const int rb = (int)(idx % (unsigned)n_rb);
  const int bk = (int)(idx / (unsigned)n_rb);  // b * K + kv head
  const int b = bk / K, kh = bk - b * K;
  const int cap = PAGED ? nT * bs : Smax;
  const int base = min(max(lengths[b], 0), cap);  // limits below stay <= cap
  const int r0 = rb * kRows, rn = min(kRows, R - r0);
  const int end = min(base + (r0 + rn - 1) / G + 1, cap);  // the last row's limit
  const int ng = (rn + kGroup - 1) / kGroup;               // the block's row groups
  const int wn = ng > rp ? (ng - rp + kParts - 1) / kParts * kGroup : 0;  // the warp's rows
  const int lo = min(base + (r0 + rp * kGroup) / G + 1, cap);  // its first row's limit
  const int bsz = PAGED ? bs : kChunk;                     // positions a table entry maps
  const int span = bps * bsz;                              // positions a split covers
  const int p0 = split * span, p1 = min(p0 + span, end);
  const size_t row0 = (size_t)bk * R + r0;  // the block's first query row
  // the queries and limits load beside lengths[b] (a dead block drops them)
  for (int i = t; i < kRows * hd; i += kThreads) {
    const int r = i / hd;
    qs[i] = r < rn ? dot_in<LOWP>(to_f32(q[row0 * hd + i]) * scale) : 0.f;
  }
  if (t < kRows) lim[t] = t < rn ? min(base + (r0 + t) / G + 1, cap) : 0;
  if (p0 >= p1) return;

  const int ch = chunk_positions(bsz);
  const int n_chunks = (p1 - p0 + ch - 1) / ch;
  const int elt = (int)sizeof(TKV);  // the cache's element
  const int k_row = hd * elt, v_row = hdv * elt;  // bytes of a cache row
  const size_t k_stride = (size_t)K * k_row, v_stride = (size_t)K * v_row;  // a position apart
  // contiguous: sequence b's rows; paged: the pool's
  const size_t seq = PAGED ? 0 : (size_t)b * Smax;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) + seq * k_stride + (size_t)kh * k_row;
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) + seq * v_stride + (size_t)kh * v_row;

  // the cache row of position t of chunk c (-1 past the chunk): its table
  // entry is this thread's load
  const auto row_of = [&](int c) -> int {
    const int pos = p0 + c * ch + t;
    if (t >= ch || pos >= p1) return -1;
    if (!PAGED) return pos;
    const int j = pos / bs;
    return min(max(table[(size_t)b * nT + j], 0), NB - 1) * bs + (pos - j * bs);
  };
  // issue the copies of chunk c into its stage, as one group
  const auto issue = [&](int c) {
    const int n = min(ch, p1 - (p0 + c * ch)), st = c % kStages;
    uint8_t* kdst = stages + st * lay.stage;
    const int* pr = prow + st * kChunk;
    copy_rows(kdst, lay.kp, kb, k_stride, pr, n, k_row / kcw, kcw, t);
    copy_rows(kdst + kChunk * lay.kp, lay.vp, vb, v_stride, pr, n, v_row / vcw, vcw, t);
    cp_async_commit();
  };

  float m[RW], l[RW], acc[RW][JV];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int jv = 0; jv < JV; ++jv) acc[r][jv] = 0.f;
  }
  const int kw0 = slice * kWarpKeys;  // the warp's first key of a chunk
  const int key = kw0 + (lane & 15), half = lane >> 4;
  float* wp = pw + warp * kWarpKeys * RW;  // the warp's p: [key][row]

  // both stages' copies in flight from the start; chunk c + 2 is issued as
  // soon as every warp is done with chunk c
  for (int c = 0; c < 2 && c < n_chunks; ++c) {
    const int pr = row_of(c);
    if (pr >= 0) prow[c * kChunk + t] = pr;
  }
  __syncthreads();
  issue(0);
  if (n_chunks > 1) issue(1);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) cp_async_wait_one();
    else cp_async_wait_all();
    __syncthreads();  // chunk c is in for every thread
    const int next = c + 2 < n_chunks ? row_of(c + 2) : -1;  // in flight over this chunk
    const int c0 = p0 + c * ch;
    const int nk = min(ch, p1 - c0);           // the chunk's positions
    const int nkw = min(kWarpKeys, nk - kw0);  // the warp's
    if (nkw > 0 && wn > 0) {
      const uint8_t* st = stages + (c % kStages) * lay.stage;
      const TKV* kr = reinterpret_cast<const TKV*>(st + key * lay.kp);
      const uint8_t* vrows = st + kChunk * lay.kp;
      const bool valid = (lane & 15) < nkw;
      const bool causal = c0 + nk > lo;  // some row's limit falls inside the chunk
      const int pos = c0 + key;
      // the scores of the warp's rows, then p; the rows' reductions interleave
      float pr[RW], red[RW];
#pragma unroll
      for (int g0 = 0; g0 < RW; g0 += kGroup) {
        if (g0 >= wn) continue;  // rows past the block's (warp-uniform)
        // s = (q * scale) . k: half h sums the 4-dim groups h, h + 2, ... of hd
        const float* qg = qs + row_of_warp(g0, rp) * hd;
        float s[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) s[i] = 0.f;
#pragma unroll 2
        for (int d = 4 * half; d < hd; d += 8) {
          const float4 kv = load4(kr + d);
          const float k0 = dot_in<LOWP>(kv.x), k1 = dot_in<LOWP>(kv.y);
          const float k2 = dot_in<LOWP>(kv.z), k3 = dot_in<LOWP>(kv.w);
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + i * hd + d);
            s[i] = fmaf(qv.x, k0, s[i]);
            s[i] = fmaf(qv.y, k1, s[i]);
            s[i] = fmaf(qv.z, k2, s[i]);
            s[i] = fmaf(qv.w, k3, s[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int r = g0 + i;
          const float sv = s[i] + __shfl_xor_sync(kFull, s[i], 16);
          pr[r] = valid && (!causal || pos < lim[row_of_warp(r, rp)]) ? sv : -INFINITY;
          red[r] = pr[r];
        }
      }
      // online softmax per row: max and sum over the warp's 16 keys
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
          if (r - r % kGroup < wn) red[r] = fmaxf(red[r], __shfl_xor_sync(kFull, red[r], o));
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r - r % kGroup >= wn) continue;
        const float mn = fmaxf(m[r], red[r]);
        const float corr = exp2_ftz((m[r] - mn) * kLog2e);
        pr[r] = exp2_ftz(fmaf(pr[r], kLog2e, -mn * kLog2e));  // masked: 2^-inf = 0
        red[r] = pr[r];
        m[r] = mn;
        l[r] *= corr;
#pragma unroll
        for (int jv = 0; jv < JV; ++jv) acc[r][jv] *= corr;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
          if (r - r % kGroup < wn) red[r] += __shfl_xor_sync(kFull, red[r], o);
      }
      // p of the warp's keys to its slot, 4 rows a store, as P V takes it
#pragma unroll
      for (int g0 = 0; g0 < RW; g0 += kGroup) {
        if (g0 >= wn) continue;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) l[g0 + i] += red[g0 + i];
        if (half == 0)
          *reinterpret_cast<float4*>(wp + (lane & 15) * RW + g0) =
              make_float4(dot_in<LOWP>(pr[g0]), dot_in<LOWP>(pr[g0 + 1]),
                          dot_in<LOWP>(pr[g0 + 2]), dot_in<LOWP>(pr[g0 + 3]));
      }
      __syncwarp();
      for (int kk = 0; kk < nkw; ++kk) {  // O += P V over the warp's keys, in order
        const TKV* vr = reinterpret_cast<const TKV*>(vrows + (kw0 + kk) * lay.vp);
        float vv[JV];
#pragma unroll
        for (int jv = 0; jv < JV; ++jv) {
          const int dv = lane + 32 * jv;
          vv[jv] = dv < hdv ? dot_in<LOWP>(to_f32(vr[dv])) : 0.f;
        }
#pragma unroll
        for (int g0 = 0; g0 < RW; g0 += kGroup) {
          if (g0 >= wn) continue;
          const float4 p4 = *reinterpret_cast<const float4*>(wp + kk * RW + g0);  // broadcast
#pragma unroll
          for (int jv = 0; jv < JV; ++jv) {
            acc[g0][jv] = fmaf(p4.x, vv[jv], acc[g0][jv]);
            acc[g0 + 1][jv] = fmaf(p4.y, vv[jv], acc[g0 + 1][jv]);
            acc[g0 + 2][jv] = fmaf(p4.z, vv[jv], acc[g0 + 2][jv]);
            acc[g0 + 3][jv] = fmaf(p4.w, vv[jv], acc[g0 + 3][jv]);
          }
        }
      }
    }
    if (c + 2 < n_chunks) {
      if (next >= 0) prow[(c % kStages) * kChunk + t] = next;
      __syncthreads();  // every warp is done with chunk c's stage
      issue(c + 2);
    }
  }

  // merge the key slices' partial softmaxes (no copies are in flight)
  __syncthreads();
  float* wb = reinterpret_cast<float*>(stages);  // [kSlices][kRows][hdv + 2]
  const int wrec = hdv + 2;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r >= wn) continue;
    float* rec = wb + (slice * kRows + row_of_warp(r, rp)) * wrec;
    if (lane == 0) {
      rec[hdv] = m[r];
      rec[hdv + 1] = l[r];
    }
#pragma unroll
    for (int jv = 0; jv < JV; ++jv) {
      const int dv = lane + 32 * jv;
      if (dv < hdv) rec[dv] = acc[r][jv];
    }
  }
  __syncthreads();
  const size_t part = ((size_t)bk * n_rb + rb) * splits;  // the row block's first partial
  for (int i = t; i < rn * hdv; i += kThreads) {
    const int r = i / hdv, dv = i - r * hdv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSlices; ++w) mx = fmaxf(mx, wb[(w * kRows + r) * wrec + hdv]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSlices; ++w) {
      const float* rec = wb + (w * kRows + r) * wrec;
      const float c = exp2_ftz((rec[hdv] - mx) * kLog2e);
      lsum = fmaf(rec[hdv + 1], c, lsum);
      a = fmaf(rec[dv], c, a);
    }
    if (splits == 1) {
      store(out + row0 * hdv + i, a / fmaxf(lsum, 1e-30f));
    } else {
      float* rec = ws + ((part + split) * kRows + r) * wrec;  // (m, l, acc)
      rec[2 + dv] = a;
      if (dv == 0) {
        rec[0] = mx;
        rec[1] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // The last of the row block's live blocks to arrive merges their partials
  // in split order (the threadFenceReduction pattern: each block's partial
  // is visible device-wide before its arrival counts) and resets the count.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int live = (end + span - 1) / span;
  if (t == 0) {
    int* count = arrivals + (size_t)bk * n_rb + rb;
    last = atomicAdd(count, 1) == live - 1;
    if (last) *count = 0;  // every live block has arrived: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each row's largest m and 1 / sum of its l, over the live splits: warp w
  // takes rows w, w + kWarps, ..., lane s the splits s, s + 32, ..., each
  // lane's (m, l) kept online, then merged across the warp
  float* mx_row = wb;          // [kRows]
  float* inv_l = wb + kRows;   // [kRows]
  const size_t step = (size_t)kRows * wrec;   // a split's partial apart
  const float* rec0 = ws + part * kRows * wrec;  // split 0's partial of row 0
  constexpr int kRowsWarp = (kRows + kWarps - 1) / kWarps;
  float wm[kRowsWarp], wl[kRowsWarp];
#pragma unroll
  for (int j = 0; j < kRowsWarp; ++j) {
    wm[j] = kNegInf;
    wl[j] = 0.f;
  }
  for (int s = lane; s < live; s += 32) {
    float pm[kRowsWarp], pl[kRowsWarp];
#pragma unroll
    for (int j = 0; j < kRowsWarp; ++j) {  // every row's loads in flight together
      const int r = warp + j * kWarps;
      const float* p = rec0 + s * step + r * wrec;
      pm[j] = r < rn ? __ldcg(p) : kNegInf;
      pl[j] = r < rn ? __ldcg(p + 1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowsWarp; ++j) {
      const float mn = fmaxf(wm[j], pm[j]);
      wl[j] = wl[j] * exp2_ftz((wm[j] - mn) * kLog2e) + pl[j] * exp2_ftz((pm[j] - mn) * kLog2e);
      wm[j] = mn;
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsWarp; ++j) {
    const int r = warp + j * kWarps;
    float mx = wm[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float lsum = wl[j] * exp2_ftz((wm[j] - mx) * kLog2e);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(kFull, lsum, o);
    if (lane == 0 && r < rn) {
      mx_row[r] = mx;
      inv_l[r] = 1.f / fmaxf(lsum, 1e-30f);
    }
  }
  __syncthreads();
  // o = sum over splits of acc 2^(m - mx) / l, in split order; a thread's
  // elements t, t + kThreads, ... load together
  constexpr int kPer = (kRows * 32 * JV + kThreads - 1) / kThreads;  // elements a thread
  float o[kPer], mr[kPer];
  int mo[kPer], ao[kPer];  // element j's m and acc in a partial (mo -1: past the rows)
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kThreads, r = i / hdv;
    o[j] = 0.f;
    mo[j] = i < rn * hdv ? r * wrec : -1;
    ao[j] = r * wrec + 2 + (i - r * hdv);
    mr[j] = i < rn * hdv ? mx_row[r] : 0.f;
  }
#pragma unroll 2
  for (int s = 0; s < live; ++s) {
    const float* rec = rec0 + s * step;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (mo[j] < 0) continue;
      const float c = exp2_ftz((__ldcg(rec + mo[j]) - mr[j]) * kLog2e);
      o[j] = fmaf(__ldcg(rec + ao[j]), c, o[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kThreads;
    if (mo[j] >= 0) store(out + row0 * hdv + i, o[j] * inv_l[i / hdv]);
  }
}

struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* out;
  float* ws;
  int* arrivals;
  int B, K, S, G, Smax, NB, bs, nT, hd, hdv;
  float scale;
  int splits, bps;
  cudaStream_t stream;
};

// the widest copy (16, 8, 4 or 2 bytes) that a cache row of row_bytes at
// base allows: rows start at base + n * row_bytes
int copy_width(const void* base, int row_bytes) {
  const unsigned long long a = (unsigned long long)base | (unsigned long long)row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

template <typename TQ, typename TKV, int JV, bool LOWP, bool PAGED>
cudaError_t launch(const Args& a) {
  const Layout lay(a.hd, a.hdv, (int)sizeof(TKV));
  auto kernel = flash_decode_spec_split<TQ, TKV, JV, LOWP, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         lay.total);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.B * a.K * ((a.S * a.G + kRows - 1) / kRows) * a.splits;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, lay.total, a.stream>>>(
      (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, a.table, a.lengths, (TQ*)a.out, a.ws,
      a.arrivals, a.K, a.S, a.G, a.Smax, a.NB, a.bs, a.nT, a.hd, a.hdv, a.scale, a.splits,
      a.bps, copy_width(a.k, a.hd * (int)sizeof(TKV)), copy_width(a.v, a.hdv * (int)sizeof(TKV)));
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool LOWP, bool PAGED>
cudaError_t launch_jv(const Args& a) {
  switch (value_regs(a.hdv)) {
    case 1: return launch<TQ, TKV, 1, LOWP, PAGED>(a);
    case 2: return launch<TQ, TKV, 2, LOWP, PAGED>(a);
    default: return launch<TQ, TKV, 4, LOWP, PAGED>(a);
  }
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_lowp(const Args& a, int lowp) {
  return lowp ? launch_jv<TQ, TKV, true, PAGED>(a) : launch_jv<TQ, TKV, false, PAGED>(a);
}

// q_bf16 / kv_bf16: the query (and output) and the cache in bf16, else f32;
// all four pairs, as the reference casts both to the dots' type in the kernel
template <bool PAGED>
int run(const Args& a, int rb, int q_bf16, int kv_bf16, int lowp, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // table entries a split's range is cut from: pool blocks, or 64-position
  // blocks of the contiguous cache
  const long long n_tbl = PAGED ? a.nT : (a.Smax + (long long)kChunk - 1) / kChunk;
  const int elt = kv_bf16 ? 2 : 4;  // the staged rows are the cache's
  if (a.hd % 4 != 0 || a.hd < 4 || a.hdv < 1 || a.hdv > 128 || a.S < 1 || a.G < 1 ||
      a.K < 1 || rb != kRows || (long long)a.S * a.G > 0x3fffffff ||
      (PAGED ? (a.bs < 1 || a.nT < 1 || a.NB < 1) : a.Smax < 1) || a.splits < 1 ||
      a.bps < 1 || (long long)a.splits * a.bps < n_tbl ||
      (long long)(a.splits - 1) * a.bps >= n_tbl ||
      (a.splits > 1 && (a.ws == nullptr || a.arrivals == nullptr)) ||
      Layout(a.hd, a.hdv, elt).total + (int)sizeof(int) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (q_bf16)
    return (int)(kv_bf16 ? launch_lowp<bf16, bf16, PAGED>(a, lowp)
                         : launch_lowp<bf16, float, PAGED>(a, lowp));
  return (int)(kv_bf16 ? launch_lowp<float, bf16, PAGED>(a, lowp)
                       : launch_lowp<float, float, PAGED>(a, lowp));
}

}  // namespace

extern "C" {

// Bytes of shared memory one split block needs (elt: bytes of a cache element).
long long flash_decode_spec_smem_bytes(int hd, int hdv, int elt) {
  return (long long)Layout(hd, hdv, elt).total + (long long)sizeof(int);
}

int flash_decode_spec_max_smem_bytes() { return kMaxSmem; }

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take. Each row
// block of rb rows is cut into splits blocks of bps table entries (pool
// blocks, or 64-position blocks of the contiguous cache); with splits > 1,
// ws holds (B*K*row blocks, splits, rb, 2 + hdv) floats and arrivals
// B*K*row blocks ints that are zero (each call leaves them so). q_bf16: q
// and out in bf16, kv_bf16: the cache in bf16 (f32 otherwise, each
// independently).
int flash_decode_spec(const void* q, const void* k, const void* v, const void* lengths,
                      void* out, void* ws, void* arrivals, int B, int K, int S, int G,
                      int Smax, int hd, int hdv, float scale, int rb, int splits, int bps,
                      int q_bf16, int kv_bf16, int lowp, int device, void* stream) {
  const Args a{q, k, v, nullptr, (const int*)lengths, out, (float*)ws, (int*)arrivals,
               B, K, S, G, Smax, 0, 0, 0, hd, hdv, scale, splits, bps,
               (cudaStream_t)stream};
  return run<false>(a, rb, q_bf16, kv_bf16, lowp, device);
}

int flash_decode_spec_paged(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* lengths, void* out, void* ws,
                            void* arrivals, int B, int K, int S, int G, int NB, int bs,
                            int nT, int hd, int hdv, float scale, int rb, int splits,
                            int bps, int q_bf16, int kv_bf16, int lowp, int device,
                            void* stream) {
  const Args a{q, k_pool, v_pool, (const int*)table, (const int*)lengths, out, (float*)ws,
               (int*)arrivals, B, K, S, G, 0, NB, bs, nT, hd, hdv, scale, splits, bps,
               (cudaStream_t)stream};
  return run<true>(a, rb, q_bf16, kv_bf16, lowp, device);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
