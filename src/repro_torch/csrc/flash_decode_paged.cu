// Single-query flash decode for Hopper (sm_90a), over a contiguous or a paged
// KV cache.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _decode_kernel (flash_decode) and _decode_paged_kernel (flash_decode_paged),
// which is _decode_kernel behind a block table. The G query heads that share
// a KV head get an online softmax over the positions < min(lengths[b],
// capacity); a row of length 0 returns zeros, and a length past the capacity
// reads it all (an idle serving slot that retired at max_seq decodes with
// max_seq + 1). An optional explicit softmax scale, and a value head dim hdv
// that may differ from hd. Under lowp q * scale, k, v and p are rounded to
// bf16 at the reference's points, l summing the unrounded p.
//
// The address map is a template parameter: contiguous row b * Smax + p of the
// (B,Smax,K,hd) cache (capacity Smax), or pool row table[b, min(p / bs,
// T - 1)] * bs + p % bs of the (NB,bs,K,hd) pool (capacity T * bs), the table
// entry clamped to [0, NB - 1] (the wrapper clamps too, as the reference clips
// the table). The contiguous cache is read as a table of ceil(Smax / 64)
// blocks of 64 positions, so both maps share the plan, the chunks and the
// merge below.
//
// What bounds it on the H100: the bytes of the live cache. Each cached
// element read feeds 2 G FLOPs (8 at G = 4), far below f32 CUDA-core balance
// (20 FLOPs a byte). At the serve shape (B8 K8 G4 hd64, 3,753 live
// positions) that is 15.4 MB, 0.0046 ms at 3.35 TB/s.
//
// What the design does about it: split the keys across blocks, so that
// every SM has copies in flight.
//  - The grid is 1-D over (split, row group, kv head, b). A split is a
//    contiguous range of `bps` whole table entries of the row (the wrapper's
//    plan, kernels/flash_attention.py::decode_paged_plan, from T, bs, B*K
//    and the SM count); a row group is 4 of the G query rows. A block whose
//    range starts at or past the row's length returns at once.
//  - A paged block translates its pool blocks once (the table entries into
//    shared memory). A block stages its positions' K and V rows of its kv
//    head in chunks of up to 64 positions (whole pool blocks where bs <= 64)
//    through a 2-stage ring of cp.async copies, 16 bytes each where the rows
//    allow it: a position's hd elements are contiguous, positions K * hd
//    apart. The next chunk's copies are issued right after the one barrier
//    of a chunk, so they overlap this chunk's arithmetic.
//  - Each of the 4 warps takes 16 keys of a chunk: lane (key, half) sums
//    half of the head dims of q.k for the 4 rows, one shuffle joins the
//    halves, and the warp keeps its own online softmax (row max and sum over
//    16 lanes, p = 2^(s log2 e - m log2 e) as one FMA and one ex2.approx);
//    for P V each lane owns value dims lane + 32 j and takes p by shuffle.
//  - The 4 warps' (m, l, acc) merge in shared memory at the end. With one
//    split the block writes o; with more it writes its f32 partial (m, l and
//    the unnormalised acc) to a workspace the wrapper allocates, and the
//    last live block of its row group to arrive (an atomic count it resets
//    itself, B*K*ceil(G/4) ints the wrapper keeps zero) merges the row's
//    live splits in order (a second launch for the merge cost more device
//    time than the merge itself: PERF.md, section 6). Nothing syncs the
//    host, and two calls give the same bits.
//  - Shared memory at hd 64 f32: 2 stages of 64 x (272 + 256) bytes, 1 KB of
//    queries and (paged) the table entries, 69.7 KB: three blocks an SM.
//
// Layout: q (B,K,G,hd); k (B,Smax,K,hd) or k_pool (NB,bs,K,hd), v likewise
// with hdv; table (B,T) int32, lengths (B,) int32, out (B,K,G,hdv), all
// contiguous, f32 or bf16, hd a multiple of 4, hdv <= 128; the workspace
// ws_ml (B*K, splits, G, 2) and ws_acc (B*K, splits, G, hdv) f32. The
// kernels allocate nothing and launch on the caller's stream. This file is
// self-contained (no shared header), so the build's hash of it covers
// everything it compiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                    // query rows of a block (a row group)
constexpr int kChunk = 64;                  // positions a stage holds
constexpr int kWarpKeys = kChunk / kWarps;  // keys of a chunk each warp takes
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

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

// Shared memory of a split block: the row group's scaled queries (f32), two
// stages of kChunk K rows (padded by 16 bytes so that the lanes of a warp
// hit different banks) and kChunk V rows, each stage's pool rows, then the
// block's table entries. The warps' merge reuses the stages.
struct Layout {
  int kp, vp;           // bytes of a staged K row, V row
  int stage;            // bytes of a stage
  int q_bytes, prow_off, tbl_off, total;
  __host__ __device__ Layout(int hd, int hdv, int bps, int elt)
      : kp(round16(hd * elt) + 16), vp(round16(hdv * elt)), stage(kChunk * (kp + vp)),
        q_bytes(kRows * hd * 4), prow_off(0), tbl_off(0), total(0) {
    int stages = kStages * stage;
    const int merge = kWarps * kRows * (hdv + 2) * 4;
    if (merge > stages) stages = merge;
    prow_off = q_bytes + stages;
    tbl_off = prow_off + kStages * kChunk * 4;
    total = tbl_off + bps * 4;
  }
};

// positions a chunk holds: whole pool blocks where bs <= kChunk
__host__ __device__ inline int chunk_positions(int bs) {
  return bs <= kChunk ? (kChunk / bs) * bs : kChunk;
}

// Block (split, row group, kv head, b): the online softmax of its 4 query
// rows over its range of positions, written as o (splits == 1) or as an f32
// partial (m, l, acc) of the workspace. JV = value dims a lane holds in 32s
// (hdv <= 32 JV); kcw and vcw are the copy widths in bytes of K and V rows.
// PAGED: k and v are pools read through the table, n_cache = NB pool blocks;
// else the contiguous cache, n_cache = Smax, bs = kChunk and nT =
// ceil(Smax / kChunk) (no table).
template <typename T, int JV, bool LOWP, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                   int* __restrict__ arrivals, int K, int G,
                   int n_cache, int bs, int nT, int hd, int hdv, float scale, int splits,
                   int bps, int kcw, int vcw) {
  const Layout lay(hd, hdv, bps, (int)sizeof(T));
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(sm);      // [kRows][hd]
  uint8_t* stages = sm + lay.q_bytes;            // [kStages][kChunk K rows, kChunk V rows]
  int* prow = reinterpret_cast<int*>(sm + lay.prow_off);  // [kStages][kChunk] pool rows
  int* tbl = reinterpret_cast<int*>(sm + lay.tbl_off);    // [bps] clamped table entries

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_rg = (G + kRows - 1) / kRows;
  unsigned idx = blockIdx.x;
  const int split = (int)(idx % (unsigned)splits);
  idx /= (unsigned)splits;
  const int rg = (int)(idx % (unsigned)n_rg);
  const int bk = (int)(idx / (unsigned)n_rg);  // b * K + kv head
  const int b = bk / K, kh = bk - b * K;
  const int cap = PAGED ? nT * bs : n_cache;
  const int len = min(max(lengths[b], 0), cap);
  const int p0 = split * bps * bs, p1 = min(p0 + bps * bs, len);
  const int g0 = rg * kRows, gn = min(kRows, G - g0);
  const size_t row0 = (size_t)bk * G + g0;  // the block's first query row
  // the queries and the block's table entries load beside lengths[b] (a
  // dead block drops them)
  for (int i = t; i < kRows * hd; i += kThreads) {
    const int r = i / hd;
    qs[i] = r < gn ? dot_in<LOWP>(to_f32(q[row0 * hd + i]) * scale) : 0.f;
  }
  const int first = split * bps;  // the block's first table entry
  if constexpr (PAGED) {
    const int n_tbl = min(bps, nT - first);
    for (int i = t; i < n_tbl; i += kThreads)
      tbl[i] = min(max(table[(size_t)b * nT + first + i], 0), n_cache - 1);
  }
  if (p0 >= p1) {
    if (split == 0)  // a row of length 0 returns zeros
      for (int i = t; i < gn * hdv; i += kThreads) store(out + row0 * hdv + i, 0.f);
    return;
  }
  __syncthreads();

  const int ch = chunk_positions(bs);
  const int n_chunks = (p1 - p0 + ch - 1) / ch;
  const int elt = (int)sizeof(T);
  const int k_row = hd * elt, v_row = hdv * elt;  // bytes of a cache row
  const size_t k_stride = (size_t)K * k_row, v_stride = (size_t)K * v_row;  // a position apart
  // paged: the pool's rows; contiguous: sequence b's
  const size_t seq = PAGED ? 0 : (size_t)b * n_cache;
  const uint8_t* kb =
      reinterpret_cast<const uint8_t*>(k_pool) + seq * k_stride + (size_t)kh * k_row;
  const uint8_t* vb =
      reinterpret_cast<const uint8_t*>(v_pool) + seq * v_stride + (size_t)kh * v_row;

  // the cache row of each position of chunk c, into its stage's prow
  const auto translate = [&](int c) {
    const int c0 = p0 + c * ch;
    if (t < min(ch, p1 - c0)) {
      const int pos = c0 + t;
      if constexpr (PAGED) {
        const int j = pos / bs;
        prow[(c % kStages) * kChunk + t] = tbl[j - first] * bs + (pos - j * bs);
      } else {
        prow[(c % kStages) * kChunk + t] = pos;
      }
    }
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

  float m[kRows], l[kRows], acc[kRows][JV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int jv = 0; jv < JV; ++jv) acc[r][jv] = 0.f;
  }
  const int kw0 = warp * kWarpKeys;         // the warp's first key of a chunk
  const int key = kw0 + (lane & 15), half = lane >> 4;

  // both stages' copies in flight from the start; chunk c + 2 is issued as
  // soon as every warp is done with chunk c
  translate(0);
  if (n_chunks > 1) translate(1);
  __syncthreads();
  issue(0);
  if (n_chunks > 1) issue(1);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) cp_async_wait_one();
    else cp_async_wait_all();
    __syncthreads();  // chunk c is in for every thread
    const int nk = min(ch, p1 - (p0 + c * ch));  // the chunk's positions
    const int nkw = min(kWarpKeys, nk - kw0);     // the warp's
    if (nkw > 0) {
      const uint8_t* st = stages + (c % kStages) * lay.stage;
      const T* kr = reinterpret_cast<const T*>(st + key * lay.kp);
      const uint8_t* vrows = st + kChunk * lay.kp;

      // s = (q * scale) . k: half h sums the 4-dim groups h, h + 2, ... of hd
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 2
      for (int d = 4 * half; d < hd; d += 8) {
        const float4 kv = load4(kr + d);
        const float k0 = dot_in<LOWP>(kv.x), k1 = dot_in<LOWP>(kv.y);
        const float k2 = dot_in<LOWP>(kv.z), k3 = dot_in<LOWP>(kv.w);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * hd + d);
          s[r] = fmaf(qv.x, k0, s[r]);
          s[r] = fmaf(qv.y, k1, s[r]);
          s[r] = fmaf(qv.z, k2, s[r]);
          s[r] = fmaf(qv.w, k3, s[r]);
        }
      }
      const bool valid = (lane & 15) < nkw;
      float pr[kRows];  // p as P V takes it
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sv = s[r] + __shfl_xor_sync(kFull, s[r], 16);
        sv = valid ? sv : -INFINITY;
        float mx = sv;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float mn = fmaxf(m[r], mx);
        const float corr = exp2_ftz((m[r] - mn) * kLog2e);
        const float p = exp2_ftz(fmaf(sv, kLog2e, -mn * kLog2e));  // masked: 2^-inf = 0
        float sum = p;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        l[r] = fmaf(l[r], corr, sum);
        m[r] = mn;
#pragma unroll
        for (int jv = 0; jv < JV; ++jv) acc[r][jv] *= corr;
        pr[r] = dot_in<LOWP>(p);
      }
      for (int kk = 0; kk < nkw; ++kk) {  // O += P V over the warp's keys, in order
        const T* vr = reinterpret_cast<const T*>(vrows + (kw0 + kk) * lay.vp);
        float vv[JV];
#pragma unroll
        for (int jv = 0; jv < JV; ++jv) {
          const int dv = lane + 32 * jv;
          vv[jv] = dv < hdv ? dot_in<LOWP>(to_f32(vr[dv])) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pk = __shfl_sync(kFull, pr[r], kk);
#pragma unroll
          for (int jv = 0; jv < JV; ++jv) acc[r][jv] = fmaf(pk, vv[jv], acc[r][jv]);
        }
      }
    }
    if (c + 2 < n_chunks) {
      translate(c + 2);
      __syncthreads();  // every warp is done with chunk c's stage
      issue(c + 2);
    }
  }

  // merge the warps' partial softmaxes (no copies are in flight)
  __syncthreads();
  float* wb = reinterpret_cast<float*>(stages);  // [kWarps][kRows][hdv + 2]
  const int wrec = hdv + 2;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* rec = wb + (warp * kRows + r) * wrec;
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
  for (int i = t; i < gn * hdv; i += kThreads) {
    const int r = i / hdv, dv = i - r * hdv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wb[(w * kRows + r) * wrec + hdv]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rec = wb + (w * kRows + r) * wrec;
      const float c = exp2_ftz((rec[hdv] - mx) * kLog2e);
      lsum = fmaf(rec[hdv + 1], c, lsum);
      a = fmaf(rec[dv], c, a);
    }
    if (splits == 1) {
      store(out + row0 * hdv + i, a / fmaxf(lsum, 1e-30f));
    } else {
      const size_t wrow = ((size_t)bk * splits + split) * G + g0 + r;  // partial row
      ws_acc[wrow * hdv + dv] = a;
      if (dv == 0) {
        ws_ml[2 * wrow] = mx;
        ws_ml[2 * wrow + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // The last of the row group's live blocks to arrive merges their partials
  // in split order (the threadFenceReduction pattern: each block's partial
  // is visible device-wide before its arrival counts) and resets the count.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int live = (len + bps * bs - 1) / (bps * bs);
  if (t == 0) {
    int* count = arrivals + (size_t)bk * n_rg + rg;
    last = atomicAdd(count, 1) == live - 1;
    if (last) *count = 0;  // every live block has arrived: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < gn * hdv; i += kThreads) {
    const int r = i / hdv, dv = i - r * hdv;
    const size_t row = (size_t)bk * splits * G + g0 + r;  // its partial of split s: row + s G
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, __ldcg(ws_ml + 2 * (row + (size_t)s * G)));
    float lsum = 0.f, a = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const size_t wrow = row + (size_t)s * G;
      const float c = exp2_ftz((__ldcg(ws_ml + 2 * wrow) - mx) * kLog2e);
      lsum = fmaf(__ldcg(ws_ml + 2 * wrow + 1), c, lsum);
      a = fmaf(__ldcg(ws_acc + wrow * hdv + dv), c, a);
    }
    store(out + row0 * hdv + i, a / fmaxf(lsum, 1e-30f));
  }
}

// paged: NB pool blocks of bs positions, T table entries a row;
// contiguous: Smax positions a row, read as nT = ceil(Smax / kChunk) table
// entries of bs = kChunk
struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* out;
  float *ws_ml, *ws_acc;
  int* arrivals;
  int B, K, G, NB, Smax, bs, nT, hd, hdv;
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

template <typename T, int JV, bool LOWP, bool PAGED>
cudaError_t launch(const Args& a) {
  const Layout lay(a.hd, a.hdv, PAGED ? a.bps : 0, (int)sizeof(T));
  auto kernel = flash_decode_split<T, JV, LOWP, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         lay.total);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.B * a.K * ((a.G + kRows - 1) / kRows) * a.splits;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, lay.total, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.table, a.lengths, (T*)a.out, a.ws_ml,
      a.ws_acc, a.arrivals, a.K, a.G, PAGED ? a.NB : a.Smax, a.bs, a.nT, a.hd, a.hdv, a.scale,
      a.splits, a.bps,
      copy_width(a.k, a.hd * (int)sizeof(T)), copy_width(a.v, a.hdv * (int)sizeof(T)));
  return cudaGetLastError();
}

template <typename T, bool LOWP, bool PAGED>
cudaError_t launch_jv(const Args& a) {
  if (a.hdv <= 32) return launch<T, 1, LOWP, PAGED>(a);
  if (a.hdv <= 64) return launch<T, 2, LOWP, PAGED>(a);
  return launch<T, 4, LOWP, PAGED>(a);
}

template <bool PAGED>
int run(const Args& a, int is_bf16, int lowp, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int elt = is_bf16 ? 2 : 4;
  if (a.hd % 4 != 0 || a.hdv < 1 || a.hdv > 128 || a.bs < 1 || a.nT < 1 ||
      (PAGED ? a.NB < 1 : a.Smax < 1) || a.splits < 1 || a.bps < 1 ||
      (long long)a.splits * a.bps < a.nT || (long long)(a.splits - 1) * a.bps >= a.nT ||
      (a.splits > 1 && (a.ws_ml == nullptr || a.ws_acc == nullptr || a.arrivals == nullptr)) ||
      Layout(a.hd, a.hdv, PAGED ? a.bps : 0, elt).total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)(lowp ? launch_jv<__nv_bfloat16, true, PAGED>(a)
                      : launch_jv<__nv_bfloat16, false, PAGED>(a));
  return (int)(lowp ? launch_jv<float, true, PAGED>(a) : launch_jv<float, false, PAGED>(a));
}

}  // namespace

extern "C" {

// Bytes of shared memory one split block needs (elt: bytes of an element;
// n_tbl: the table entries a block holds, 0 for the contiguous cache).
long long flash_decode_smem_bytes(int hd, int hdv, int n_tbl, int elt) {
  return (long long)Layout(hd, hdv, n_tbl, elt).total;
}

int flash_decode_max_smem_bytes() { return kMaxSmem; }

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take. splits
// blocks of bps table entries each (pool blocks, or 64-position blocks of the
// contiguous cache) cover a row (splits * bps >= the row's entries); with
// splits > 1, ws_ml and ws_acc hold (B*K, splits, G, 2) and
// (B*K, splits, G, hdv) floats, and arrivals B*K*ceil(G/4) ints that are
// zero (each call leaves them so).
int flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 void* ws_ml, void* ws_acc, void* arrivals, int B, int K, int G, int Smax,
                 int hd, int hdv, float scale, int splits, int bps, int is_bf16, int lowp,
                 int device, void* stream) {
  const Args a{q, k, v, nullptr, (const int*)lengths, out, (float*)ws_ml, (float*)ws_acc,
               (int*)arrivals, B, K, G, 0, Smax, kChunk,
               Smax < 1 ? 0 : (Smax + kChunk - 1) / kChunk, hd, hdv, scale, splits, bps,
               (cudaStream_t)stream};
  return run<false>(a, is_bf16, lowp, device);
}

int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const void* table, const void* lengths, void* out, void* ws_ml,
                       void* ws_acc, void* arrivals, int B, int K, int G, int NB, int bs, int nT, int hd,
                       int hdv, float scale, int splits, int bps, int is_bf16, int lowp,
                       int device, void* stream) {
  const Args a{q, k_pool, v_pool, (const int*)table, (const int*)lengths, out,
               (float*)ws_ml, (float*)ws_acc, (int*)arrivals, B, K, G, NB, 0, bs, nT, hd, hdv,
               scale, splits, bps, (cudaStream_t)stream};
  return run<true>(a, is_bf16, lowp, device);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
