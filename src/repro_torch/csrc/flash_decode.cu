// Single-query flash decode for Hopper (sm_90a) over a ragged KV cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_decode_kernel
// (called through flash_decode): one new token per (batch row, KV head), the
// G query heads that share the KV head in one block, an online softmax over
// the cache up to the row's valid length, an optional explicit softmax scale
// and a value head dim hdv that may differ from hd. A row of length 0 returns
// zeros (l is clamped at 1e-30). A length above Smax is clamped to Smax: an
// idle serving slot that retired at cache_len == max_seq decodes with length
// max_seq + 1.
//
// What bounds it on the H100: decode reads each cached K/V element once and
// does 2*G FLOPs with it (G = 4 for llama3.2-1b), far below the ~20 FLOP/byte
// at which f32 CUDA-core work would take over from the 3.35 TB/s of device
// memory, so it is bound by the bytes of the live cache.
//
// What the design does about it: one block per (b, kv head) holds all G
// query rows, so each K/V row crosses device memory once per group, not once
// per query head, and only rows below min(length, Smax) are read at all.
// The block's 8 warps split the cache into 32-key chunks (warp w takes
// chunks w, w+8, ...) and each runs its own online softmax, so 8 streams of
// loads are in flight per block with no block-wide barrier inside the loop.
// Within a chunk, lane i owns key i: it reads its K row with 16-byte loads,
// four in flight at a time, and forms the scores of up to 4 (G <= 4) or 8
// query rows at once; the row max and sum are warp shuffles. For the P.V
// product each lane owns hdv/32 value columns (coalesced V-row loads) and
// receives each key's probability by shuffle.
// At the end the 8 warps' partial (m, l, acc) merge in shared memory. With
// B * K blocks the card is not full at small batch; splitting the cache
// across blocks is later work.
//
// Layout: q (B,K,G,hd), k (B,Smax,K,hd), v (B,Smax,K,hdv), out (B,K,G,hdv),
// contiguous, f32 or bf16, hd a multiple of 4, hdv <= 128; lengths (B,)
// int32. The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
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

size_t smem_floats(int G, int hd, int hdv) {
  return (size_t)G * hd                    // scaled queries
         + 2 * (size_t)kWarps * G          // per-warp running max and sum
         + (size_t)kWarps * G * hdv;       // per-warp accumulators
}

// JV = value columns per lane (hdv <= 32 * JV); ROWS = query rows scored per
// pass over a chunk (G > ROWS takes several passes)
template <typename T, int JV, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int K, int G, int Smax, int hd,
                    int hdv, float scale, int lowp_flag) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* wm = qs + G * hd;           // [warp][g]
  float* wl = wm + kWarps * G;       // [warp][g]
  float* wacc = wl + kWarps * G;     // [warp][g][hdv]

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int len = min(max(lengths[b], 0), Smax);
  const size_t q0 = ((size_t)b * K + kh) * G;  // first query row of the group
  const T* kb = k + ((size_t)b * Smax * K + kh) * hd;   // key j at kb + j*K*hd
  const T* vb = v + ((size_t)b * Smax * K + kh) * hdv;
  const size_t kstride = (size_t)K * hd, vstride = (size_t)K * hdv;

  for (int i = t; i < G * hd; i += kThreads)
    qs[i] = dot_in(to_f32(q[q0 * hd + i]) * scale, lowp);
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
        const T* kr = kb + (size_t)key * kstride;
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
        const T* vr = vb + (size_t)(key0 + kk) * vstride;
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

template <typename T, int JV, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int K, int G,
                   int Smax, int hd, int hdv, float scale, int lowp,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(G, hd, hdv) * sizeof(float);
  auto kernel = flash_decode_kernel<T, JV, ROWS>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(K, B), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, K, G, Smax, hd,
      hdv, scale, lowp);
  return cudaGetLastError();
}

template <typename T, int JV>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* lengths, void* out, int B, int K, int G,
                        int Smax, int hd, int hdv, float scale, int lowp,
                        cudaStream_t stream) {
  if (G <= 4) return launch<T, JV, 4>(q, k, v, lengths, out, B, K, G, Smax, hd, hdv, scale, lowp, stream);
  return launch<T, JV, 8>(q, k, v, lengths, out, B, K, G, Smax, hd, hdv, scale, lowp, stream);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int K, int G,
                     int Smax, int hd, int hdv, float scale, int lowp,
                     cudaStream_t stream) {
  if (hdv <= 32) return launch_rows<T, 1>(q, k, v, lengths, out, B, K, G, Smax, hd, hdv, scale, lowp, stream);
  if (hdv <= 64) return launch_rows<T, 2>(q, k, v, lengths, out, B, K, G, Smax, hd, hdv, scale, lowp, stream);
  return launch_rows<T, 4>(q, k, v, lengths, out, B, K, G, Smax, hd, hdv, scale, lowp, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs.
long long flash_decode_smem_bytes(int G, int hd, int hdv) {
  return (long long)(smem_floats(G, hd, hdv) * sizeof(float));
}

int flash_decode_max_smem_bytes() { return kMaxSmem; }

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, int B, int K, int G, int Smax,
                 int hd, int hdv, float scale, int is_bf16, int lowp,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd % 4 != 0 || hdv > 128 ||
      smem_floats(G, hd, hdv) * sizeof(float) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  if (is_bf16) {
    err = launch_t<__nv_bfloat16>(q, k, v, len, out, B, K, G, Smax, hd, hdv, scale, lowp, s);
  } else {
    err = launch_t<float>(q, k, v, len, out, B, K, G, Smax, hd, hdv, scale, lowp, s);
  }
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
