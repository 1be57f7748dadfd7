// Flash-attention forward for Hopper (sm_90a): o and lse = m + log(l).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fwd_kernel
// (called through _fwd_call): causal or full multi-head attention over
// (B, H, S, hd) with an online softmax across KV tiles, q_offset shifting the
// causal diagonal, KV tiles above the diagonal skipped, and the `lowp` rule
// (bf16 dot inputs, f32 statistics and accumulator).
//
// What bounds it on the H100: at the prefill shapes of the serve path
// (S ~ 200..512, hd 64) the work is ~4*hd FLOPs per (query, key) pair against
// 16 bytes per (row, hd) element moved, so it is bound by operations, not by
// the 3.35 TB/s of device memory. This kernel runs those operations as plain
// f32 FFMA on the CUDA cores (67 TFLOP/s peak), not on the tensor cores;
// wgmma, TMA and split-KV are later work.
//
// What the design does about it: the FMAs are fed from shared memory, whose
// 128 bytes per clock per SM would cap a kernel that loads one operand per
// FMA at a quarter of the FMA rate. So each thread computes a 4 x 4 register
// tile, as a SIMT GEMM does: a block of 64 query rows and 256 threads stages
// Q, then one 64-key tile of K and V at a time, in shared memory; thread
// (ty, tx) owns query rows ty + 16i and, for S = Q K^T, keys tx + 16j, so per
// four head dims it loads four Q and four K float4s (LDS.128) for 64 FMAs.
// The row max and sum of the online softmax reduce over the 16 threads of a
// row with four shuffles each; P goes through shared memory, and for O += P V
// the same thread owns rows ty + 16i and hd/16 contiguous head dims, again
// 4+4 float4 loads per 64 FMAs. Row strides are padded so that the eight
// lanes of each LDS.128 phase hit distinct banks or read one broadcast
// address. Each K/V tile is read from device memory once per 64 query rows.
// The TPU kernel cut its blocks with divisor_block, which falls to 1-row
// blocks for a prime S; here tiles are fixed and the ragged tails of both
// the query rows and the keys are masked in the kernel.
//
// Layout: q (B,H,Sq,HD), k and v (B,H,Sk,HD), o (B,H,Sq,HD), all contiguous,
// in f32 or bf16, HD in {16, 32, 64, 128}; lse (B,H,Sq) f32. The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of (ty, tx)
constexpr int kPRow = kBK + 16;    // P row stride: a warp's two rows on opposite bank halves

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// a dot input: bf16-rounded under `lowp`, else as is
__device__ __forceinline__ float dot_in(float x, bool lowp) {
  return lowp ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// reduce over the 16 lanes (tx) that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
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

__host__ __device__ constexpr int row_stride(int hd) { return hd + 4; }

constexpr size_t smem_floats(int hd) {
  return 3 * (size_t)kBQ * row_stride(hd) + (size_t)kBQ * kPRow;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int causal,
                 int q_offset, float scale, int lowp_flag) {
  constexpr int ROW = row_stride(HD);  // Q/K/V shared-memory row stride (floats)
  constexpr int DPT = HD / 16;         // output head dims per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][ROW]
  float* ks = qs + kBQ * ROW;                   // [kBK][ROW]
  float* vs = ks + kBK * ROW;                   // [kBK][ROW]
  float* ps = vs + kBK * ROW;                   // [kBQ][kPRow]

  const bool lowp = lowp_flag != 0;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int row0 = (int)blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * HD;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;

  for (int idx = t; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    qs[r * ROW + c] = row < Sq ? dot_in(to_f32(qb[(size_t)row * HD + c]) * scale, lowp) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    // skip KV tiles above the diagonal of this block's last live row
    const int last_key = min(row0 + kBQ - 1, Sq - 1) + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kBK;
    __syncthreads();  // Q is staged; the previous tile's K, V and P are consumed
    for (int idx = t; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      const int key = key0 + r;
      const bool in = key < Sk;
      ks[r * ROW + c] = in ? dot_in(to_f32(kb[(size_t)key * HD + c]), lowp) : 0.f;
      vs[r * ROW + c] = in ? dot_in(to_f32(vb[(size_t)key * HD + c]), lowp) : 0.f;
    }
    __syncthreads();

    // S = Q K^T on this thread's rows ty + 16i and keys tx + 16jn
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) s[i][jn] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ROW + d);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        kf[jn] = *reinterpret_cast<const float4*>(ks + (tx + 16 * jn) * ROW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          s[i][jn] = fmaf(qf[i].x, kf[jn].x, s[i][jn]);
          s[i][jn] = fmaf(qf[i].y, kf[jn].y, s[i][jn]);
          s[i][jn] = fmaf(qf[i].z, kf[jn].z, s[i][jn]);
          s[i][jn] = fmaf(qf[i].w, kf[jn].w, s[i][jn]);
        }
    }

    // online softmax per row; P goes to shared memory for the P V product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int key = key0 + tx + 16 * jn;
        const bool ok = key < Sk && (!causal || key <= row + q_offset);
        s[i][jn] = ok ? s[i][jn] : kNegInf;
        mx = fmaxf(mx, s[i][jn]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        // keys past Sk exist only in this padded tile: they weigh exactly 0
        const float p = key0 + tx + 16 * jn < Sk ? expf(s[i][jn] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * kPRow + tx + 16 * jn] = dot_in(p, lowp);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // O += P V on rows ty + 16i and head dims tx*DPT .. tx*DPT + DPT - 1
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPRow + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DPT];
        lds<DPT>(vs + (kk + u) * ROW + tx * DPT, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pf[i].x : u == 1 ? pf[i].y : u == 2 ? pf[i].z : pf[i].w;
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < Sq) {
      const float lc = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lc;
      T* orow = o + (bh * Sq + row) * HD + tx * DPT;
#pragma unroll
      for (int e = 0; e < DPT; ++e) store(orow + e, acc[i][e] * inv);
      if (tx == 0) lse[bh * Sq + row] = m[i] + logf(lc);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      float* lse, int BH, int Sq, int Sk, int causal,
                      int q_offset, float scale, int lowp,
                      cudaStream_t stream) {
  constexpr size_t bytes = smem_floats(HD) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, causal,
      q_offset, scale, lowp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int Sq, int Sk, int hd, int causal,
                     int q_offset, float scale, int lowp,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset, scale, lowp, stream);
    case 32: return launch_hd<T, 32>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset, scale, lowp, stream);
    case 64: return launch_hd<T, 64>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset, scale, lowp, stream);
    case 128: return launch_hd<T, 128>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset, scale, lowp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim the kernel was not built for.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Sq, int Sk, int hd, int causal, int q_offset,
              float scale, int is_bf16, int lowp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    err = launch_t<__nv_bfloat16>(q, k, v, o, (float*)lse, B * H, Sq, Sk, hd,
                                  causal, q_offset, scale, lowp, s);
  } else {
    err = launch_t<float>(q, k, v, o, (float*)lse, B * H, Sq, Sk, hd, causal,
                          q_offset, scale, lowp, s);
  }
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
