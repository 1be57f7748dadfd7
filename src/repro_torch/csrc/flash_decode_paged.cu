// Single-query flash decode for Hopper (sm_90a) over a paged KV cache.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_decode_paged_kernel (called through
// flash_decode_paged): the math of _decode_kernel (csrc/flash_decode.cu) with
// the KV held in a block pool shared by all sequences. Row b's virtual cache
// position p lives at offset p % bs of physical block
// table[b, min(p / bs, T - 1)], the table entry clamped to [0, NB - 1] (the
// wrapper clamps too, as the reference clips the table). The G query heads
// that share a KV head sit in one block with an online softmax over the
// positions < min(lengths[b], T * bs); a row of length 0 returns zeros. An
// optional explicit softmax scale, and a value head dim hdv that may differ
// from hd.
//
// What bounds it on the H100: as flash_decode, the bytes of the live cache
// (2*G FLOPs per cached element read, far below f32 CUDA-core balance).
//
// What the design does about it: flash_decode's shape, unchanged: one block
// per (b, kv head) holding all G rows, 8 warps on interleaved 32-key chunks,
// each with its own online softmax, lane i owning key i and reading its K row
// with 16-byte loads, four in flight; the warps' partials merge in shared
// memory at the end. The row's T table entries are staged in shared memory
// once per block, so translating a position costs a shared-memory read, not
// a device-memory one. A 32-key chunk spans 32 / bs pool blocks (two at
// bs = 16); each lane translates its own key, so K rows are still read 16
// bytes at a time along hd, and V rows stay coalesced across the lanes. The
// grid is B*K blocks, 64 at the serve shape: fewer than the card's 132 SMs,
// so a second resident block per SM buys nothing there, and
// __launch_bounds__(.., 1) lets ptxas spend registers on the loop instead
// (under the default bound it kept this kernel's tiles small, some
// spilling, and the kernel ran at half flash_decode's speed; PERF.md).
//
// Layout: q (B,K,G,hd), k_pool (NB,bs,K,hd), v_pool (NB,bs,K,hdv),
// table (B,T) int32, lengths (B,) int32, out (B,K,G,hdv), all contiguous,
// f32 or bf16, hd a multiple of 4, hdv <= 128. The kernel allocates nothing
// and launches on the caller's stream. This file is self-contained (no
// shared header), so the build's hash of it covers everything it compiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGridY = 65535;    // rows of the batch per launch: the limit of grid.y

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

// pool row (physical block * bs + offset) of virtual position p < T * bs
__device__ __forceinline__ long long pool_row(const int* tbl, int p, int bs, int nT) {
  const int j = min(p / bs, nT - 1);
  return (long long)tbl[j] * bs + (p - (p / bs) * bs);
}

size_t smem_bytes(int G, int hd, int hdv, int nT) {
  return ((size_t)G * hd                   // scaled queries
          + 2 * (size_t)kWarps * G         // per-warp running max and sum
          + (size_t)kWarps * G * hdv)      // per-warp accumulators
             * sizeof(float)
         + (size_t)nT * sizeof(int);       // the row's block table
}

// JV = value columns per lane (hdv <= 32 * JV); ROWS = query rows scored per
// pass over a chunk (G > ROWS takes several passes)
template <typename T, int JV, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          int K, int G, int NB, int bs, int nT, int hd,
                          int hdv, float scale, int lowp_flag) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* wm = qs + G * hd;           // [warp][g]
  float* wl = wm + kWarps * G;       // [warp][g]
  float* wacc = wl + kWarps * G;     // [warp][g][hdv]
  int* tbl = reinterpret_cast<int*>(wacc + kWarps * G * hdv);  // [T]

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int len = min(max(lengths[b], 0), nT * bs);
  const size_t q0 = ((size_t)b * K + kh) * G;  // first query row of the group
  const T* kb = k_pool + (size_t)kh * hd;     // pool row r's key at kb + r*K*hd
  const T* vb = v_pool + (size_t)kh * hdv;
  const size_t kstride = (size_t)K * hd, vstride = (size_t)K * hdv;

  for (int i = t; i < G * hd; i += kThreads)
    qs[i] = dot_in(to_f32(q[q0 * hd + i]) * scale, lowp);
  for (int i = t; i < nT; i += kThreads)
    tbl[i] = min(max(table[(size_t)b * nT + i], 0), NB - 1);
  __syncthreads();

  for (int g0 = 0; g0 < G; g0 += ROWS) {
    const int gn = min(ROWS, G - g0);
    float m[ROWS], l[ROWS], acc[ROWS][JV];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < JV; ++j) acc[r][j] = 0.f;
    }

    for (int key0 = warp * 32; key0 < len; key0 += kWarps * 32) {
      const int key = key0 + lane;
      const bool valid = key < len;
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      if (valid) {
        const T* kr = kb + pool_row(tbl, key, bs, nT) * kstride;
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
              if (r < gn) {
                const float4 qv = *reinterpret_cast<const float4*>(qs + (g0 + r) * hd + d);
                s[r] = fmaf(qv.x, kd.x, s[r]);
                s[r] = fmaf(qv.y, kd.y, s[r]);
                s[r] = fmaf(qv.z, kd.z, s[r]);
                s[r] = fmaf(qv.w, kd.w, s[r]);
              }
            }
          }
        }
      }
      // online softmax over this chunk, per query row; s becomes p
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
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
      const int nk = min(32, len - key0);
#pragma unroll 8
      for (int kk = 0; kk < nk; ++kk) {
        const T* vr = vb + pool_row(tbl, key0 + kk, bs, nT) * vstride;
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

    for (int r = 0; r < gn; ++r) {
      const int g = g0 + r;
      if (lane == 0) {
        wm[warp * G + g] = m[r];
        wl[warp * G + g] = l[r];
      }
#pragma unroll
      for (int j = 0; j < JV; ++j) {
        const int dv = lane + 32 * j;
        if (dv < hdv) wacc[(warp * G + g) * hdv + dv] = acc[r][j];
      }
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes
  for (int i = t; i < G * hdv; i += kThreads) {
    const int g = i / hdv, dv = i - g * hdv;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * G + g] - mx);
      lsum = fmaf(wl[w * G + g], c, lsum);
      a = fmaf(wacc[(w * G + g) * hdv + dv], c, a);
    }
    store(out + q0 * hdv + i, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* out;
  int B, K, G, NB, bs, nT, hd, hdv;
  float scale;
  int lowp;
  cudaStream_t stream;
};

template <typename T, int JV, int ROWS>
cudaError_t launch(const Args& a) {
  const size_t bytes = smem_bytes(a.G, a.hd, a.hdv, a.nT);
  auto kernel = flash_decode_paged_kernel<T, JV, ROWS>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  // grid.y holds at most 65535 rows of the batch: a larger B runs in chunks,
  // each launch with its base pointers advanced (the kernel body unchanged)
  for (int b0 = 0; b0 < a.B; b0 += kMaxGridY) {
    const int n = a.B - b0 < kMaxGridY ? a.B - b0 : kMaxGridY;
    const size_t rows = (size_t)b0 * a.K * a.G;
    kernel<<<dim3(a.K, n), kThreads, bytes, a.stream>>>(
        (const T*)a.q + rows * a.hd, (const T*)a.k, (const T*)a.v,
        a.table + (size_t)b0 * a.nT, a.lengths + b0, (T*)a.out + rows * a.hdv, a.K,
        a.G, a.NB, a.bs, a.nT, a.hd, a.hdv, a.scale, a.lowp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int JV>
cudaError_t launch_rows(const Args& a) {
  return a.G <= 4 ? launch<T, JV, 4>(a) : launch<T, JV, 8>(a);
}

template <typename T>
cudaError_t launch_t(const Args& a) {
  if (a.hdv <= 32) return launch_rows<T, 1>(a);
  if (a.hdv <= 64) return launch_rows<T, 2>(a);
  return launch_rows<T, 4>(a);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs.
long long flash_decode_paged_smem_bytes(int G, int hd, int hdv, int nT) {
  return (long long)smem_bytes(G, hd, hdv, nT);
}

int flash_decode_paged_max_smem_bytes() { return kMaxSmem; }

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const void* table, const void* lengths, void* out,
                       int B, int K, int G, int NB, int bs, int nT, int hd,
                       int hdv, float scale, int is_bf16, int lowp, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd % 4 != 0 || hdv > 128 || bs < 1 || nT < 1 || NB < 1 ||
      smem_bytes(G, hd, hdv, nT) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, (const int*)table, (const int*)lengths, out,
               B, K, G, NB, bs, nT, hd, hdv, scale, lowp,
               (cudaStream_t)stream};
  return (int)(is_bf16 ? launch_t<__nv_bfloat16>(a) : launch_t<float>(a));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
