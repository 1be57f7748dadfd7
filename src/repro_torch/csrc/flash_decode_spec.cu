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
// table is read). Every row attends position 0, so no row is empty.
//
// The address map is a template parameter: contiguous row b*Smax + p of the
// (B,Smax,K,hd) cache, or pool row table[b, min(p/bs, T-1)]*bs + p%bs of the
// (NB,bs,K,hd) pool, the table entry clamped to [0, NB-1] and staged in
// shared memory once per block.
//
// What bounds it on the H100: the bytes of the live cache, read once per
// (b, kv head) for all R rows (2*R FLOPs per element read: 40 at S=5, G=4,
// still below f32 CUDA-core balance).
//
// What the design does about it: flash_decode's shape (csrc/flash_decode.cu):
// one block per (b, kv head), 8 warps on interleaved 32-key chunks with their
// own online softmax, lane i owning key i (16-byte K loads along hd, four in
// flight), partials merged in shared memory. R is more than the 8-row
// register tile, so the block loops over groups of up to 8 rows, each group
// reading the keys up to its own last row's limit; the second and later
// groups re-read keys the first brought into L2. Reading the cache once for
// all R rows is later work. The grid is B*K blocks, 64 at the serve shape:
// fewer than the card's 132 SMs, so a second resident block per SM buys
// nothing there, and __launch_bounds__(.., 1) lets ptxas spend registers on
// the loop instead (under the default bound 13 of its 24 instantiations
// spilled; PERF.md).
//
// Layout: q (B,K,S,G,hd), k (B,Smax,K,hd) or (NB,bs,K,hd), v likewise with
// hdv, out (B,K,S,G,hdv), all contiguous, f32 or bf16, hd a multiple of 4,
// hdv <= 128, R <= kMaxRows; lengths (B,) int32; table (B,T) int32. The
// kernel allocates nothing and launches on the caller's stream. This file is
// self-contained (no shared header), so the build's hash of it covers
// everything it compiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
constexpr int kMaxRows = 64;       // ceiling on S*G rows per block
constexpr unsigned kFull = 0xffffffffu;

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

// a dot input: bf16-rounded under `lowp`, else as is
__device__ __forceinline__ float dot_in(float x, bool lowp) {
  return lowp ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The cache row (of K*hd elements) holding virtual position p of sequence b.
template <bool PAGED>
__device__ __forceinline__ long long cache_row(const int* tbl, int b, int p,
                                               int Smax, int bs, int nT) {
  if (PAGED) {
    const int j = min(p / bs, nT - 1);
    return (long long)tbl[j] * bs + (p - (p / bs) * bs);
  }
  return (long long)b * Smax + p;
}

size_t smem_bytes(int R, int hd, int hdv, int nT) {
  return ((size_t)R * hd                   // scaled queries
          + 2 * (size_t)kWarps * R         // per-warp running max and sum
          + (size_t)kWarps * R * hdv)      // per-warp accumulators
             * sizeof(float)
         + (size_t)nT * sizeof(int);       // the row's block table (paged)
}

// JV = value columns per lane (hdv <= 32 * JV); ROWS = rows scored per pass
// over the keys (R > ROWS takes several passes).
template <typename T, int JV, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_spec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ table,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int K, int S, int G, int Smax, int NB, int bs, int nT,
                         int hd, int hdv, float scale, int lowp_flag) {
  extern __shared__ float4 smem4[];
  const int R = S * G;
  float* qs = reinterpret_cast<float*>(smem4);
  float* wm = qs + R * hd;           // [warp][r]
  float* wl = wm + kWarps * R;       // [warp][r]
  float* wacc = wl + kWarps * R;     // [warp][r][hdv]
  int* tbl = reinterpret_cast<int*>(wacc + kWarps * R * hdv);  // [T], paged

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int cap = PAGED ? nT * bs : Smax;
  const int base = min(max(lengths[b], 0), cap);  // limits below stay <= cap
  const size_t q0 = ((size_t)b * K + kh) * R;  // first query row of the block
  const T* kb = k + (size_t)kh * hd;           // cache row c's key at kb + c*K*hd
  const T* vb = v + (size_t)kh * hdv;
  const size_t kstride = (size_t)K * hd, vstride = (size_t)K * hdv;

  for (int i = t; i < R * hd; i += kThreads)
    qs[i] = dot_in(to_f32(q[q0 * hd + i]) * scale, lowp);
  if (PAGED)
    for (int i = t; i < nT; i += kThreads)
      tbl[i] = min(max(table[(size_t)b * nT + i], 0), NB - 1);
  __syncthreads();

  for (int r0 = 0; r0 < R; r0 += ROWS) {
    const int rn = min(ROWS, R - r0);
    // keys this group reads: up to its last row's limit
    const int end = min(base + (r0 + rn - 1) / G + 1, cap);
    float m[ROWS], l[ROWS], acc[ROWS][JV];
    int lim[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
      lim[r] = min(base + (r0 + r) / G + 1, cap);
#pragma unroll
      for (int j = 0; j < JV; ++j) acc[r][j] = 0.f;
    }

    for (int key0 = warp * 32; key0 < end; key0 += kWarps * 32) {
      const int key = key0 + lane;
      const bool live = key < end;
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      if (live) {
        const T* kr = kb + cache_row<PAGED>(tbl, b, key, Smax, bs, nT) * kstride;
        for (int d0 = 0; d0 < hd; d0 += 16) {
          float4 kv[4];  // four 16-byte loads in flight before the FMAs
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kv[u] = d0 + 4 * u < hd ? load4(kr + d0 + 4 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = d0 + 4 * u;
            if (d >= hd) break;
            const float4 kd = make_float4(dot_in(kv[u].x, lowp), dot_in(kv[u].y, lowp),
                                          dot_in(kv[u].z, lowp), dot_in(kv[u].w, lowp));
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              if (r < rn) {
                const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + r) * hd + d);
                s[r] = fmaf(qv.x, kd.x, s[r]);
                s[r] = fmaf(qv.y, kd.y, s[r]);
                s[r] = fmaf(qv.z, kd.z, s[r]);
                s[r] = fmaf(qv.w, kd.w, s[r]);
              }
            }
          }
        }
      }
      // online softmax over this chunk, per row, under the row's own causal
      // limit; s becomes p (0 where masked)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool valid = key < lim[r];
        const float sv = valid ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p);
        m[r] = m_new;
        s[r] = dot_in(p, lowp);
#pragma unroll
        for (int j = 0; j < JV; ++j) acc[r][j] *= corr;
      }
      const int nk = min(32, end - key0);
#pragma unroll 8
      for (int kk = 0; kk < nk; ++kk) {
        const T* vr = vb + cache_row<PAGED>(tbl, b, key0 + kk, Smax, bs, nT) * vstride;
        float vv[JV];
#pragma unroll
        for (int j = 0; j < JV; ++j) {
          const int dv = lane + 32 * j;
          vv[j] = dv < hdv ? dot_in(to_f32(vr[dv]), lowp) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pk = __shfl_sync(kFull, s[r], kk);
#pragma unroll
          for (int j = 0; j < JV; ++j) acc[r][j] = fmaf(pk, vv[j], acc[r][j]);
        }
      }
    }

    for (int r = 0; r < rn; ++r) {
      const int row = r0 + r;
      if (lane == 0) {
        wm[warp * R + row] = m[r];
        wl[warp * R + row] = l[r];
      }
#pragma unroll
      for (int j = 0; j < JV; ++j) {
        const int dv = lane + 32 * j;
        if (dv < hdv) wacc[(warp * R + row) * hdv + dv] = acc[r][j];
      }
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes
  for (int i = t; i < R * hdv; i += kThreads) {
    const int row = i / hdv, dv = i - row * hdv;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * R + row]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * R + row] - mx);
      lsum = fmaf(wl[w * R + row], c, lsum);
      a = fmaf(wacc[(w * R + row) * hdv + dv], c, a);
    }
    store(out + q0 * hdv + i, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* out;
  int B, K, S, G, Smax, NB, bs, nT, hd, hdv;
  float scale;
  int lowp;
  cudaStream_t stream;
};

template <typename T, int JV, int ROWS, bool PAGED>
cudaError_t launch(const Args& a) {
  const size_t bytes = smem_bytes(a.S * a.G, a.hd, a.hdv, PAGED ? a.nT : 0);
  auto kernel = flash_decode_spec_kernel<T, JV, ROWS, PAGED>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.K, a.B), kThreads, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.table, a.lengths,
      (T*)a.out, a.K, a.S, a.G, a.Smax, a.NB, a.bs, a.nT, a.hd, a.hdv,
      a.scale, a.lowp);
  return cudaGetLastError();
}

template <typename T, int JV, bool PAGED>
cudaError_t launch_rows(const Args& a) {
  return a.S * a.G <= 4 ? launch<T, JV, 4, PAGED>(a) : launch<T, JV, 8, PAGED>(a);
}

template <typename T, bool PAGED>
cudaError_t launch_t(const Args& a) {
  if (a.hdv <= 32) return launch_rows<T, 1, PAGED>(a);
  if (a.hdv <= 64) return launch_rows<T, 2, PAGED>(a);
  return launch_rows<T, 4, PAGED>(a);
}

template <bool PAGED>
int run(const Args& a, int is_bf16, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int R = a.S * a.G;
  if (a.hd % 4 != 0 || a.hdv > 128 || R < 1 || R > kMaxRows ||
      (PAGED && (a.bs < 1 || a.nT < 1 || a.NB < 1)) ||
      smem_bytes(R, a.hd, a.hdv, PAGED ? a.nT : 0) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? launch_t<__nv_bfloat16, PAGED>(a)
                       : launch_t<float, PAGED>(a));
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs (nT = 0 for the contiguous cache).
long long flash_decode_spec_smem_bytes(int R, int hd, int hdv, int nT) {
  return (long long)smem_bytes(R, hd, hdv, nT);
}

int flash_decode_spec_max_smem_bytes() { return kMaxSmem; }

int flash_decode_spec_max_rows() { return kMaxRows; }

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int flash_decode_spec(const void* q, const void* k, const void* v,
                      const void* lengths, void* out, int B, int K, int S,
                      int G, int Smax, int hd, int hdv, float scale,
                      int is_bf16, int lowp, int device, void* stream) {
  const Args a{q, k, v, nullptr, (const int*)lengths, out, B, K, S, G, Smax,
               0, 0, 0, hd, hdv, scale, lowp, (cudaStream_t)stream};
  return run<false>(a, is_bf16, device);
}

int flash_decode_spec_paged(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* lengths, void* out, int B, int K,
                            int S, int G, int NB, int bs, int nT, int hd,
                            int hdv, float scale, int is_bf16, int lowp,
                            int device, void* stream) {
  const Args a{q, k_pool, v_pool, (const int*)table, (const int*)lengths, out,
               B, K, S, G, 0, NB, bs, nT, hd, hdv, scale, lowp,
               (cudaStream_t)stream};
  return run<true>(a, is_bf16, device);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
