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
// Causal masking with q_offset shifting the diagonal, the `lowp` rule (q, k,
// v and do, then p for dv and ds for both products, rounded to bf16 before
// their dots; lse, delta and every sum in f32) and f32 outputs, all as the
// TPU kernels have them.
//
// What bounds them on the H100: at the training shape (S = 512, hd = 64)
// each live (query, key) pair costs 2 * hd FLOPs per product: 3 products
// (q.k, do.v, ds.k) in the dq kernel and 4 (k.q, v.do, p^T do, ds^T q) in
// the dkv kernel, against 16-32 bytes per (row, hd) element moved. In f32
// they are bound by operations; this version runs them as f32 FFMA on the
// CUDA cores (67 TFLOP/s peak), not on the tensor cores, so with bf16
// inputs they stay far from the bytes bound. wgmma, TMA and a fused single
// pass are later work.
//
// What the design does about it: as in flash_fwd.cu, the FMAs are fed from
// shared memory through 4 x 4 register tiles (8 LDS.128 per 64 FMAs), 256
// threads as a 16 x 16 grid (ty, tx), 64-row and 64-key tiles.
//  - flash_bwd_dq: one block per (b, h, 64-row query tile). Q, dO, lse and
//    delta stay resident; the block loops over KV tiles up to the causal
//    diagonal. Thread (ty, tx) computes s and dp for rows ty + 16i and keys
//    tx + 16j, writes ds to shared memory, then accumulates dq for rows
//    ty + 16i and hd/16 contiguous head dims in registers.
//  - flash_bwd_dkv: one block per (b, h, 64-key tile). K and V stay
//    resident; the block loops over query tiles from the first one that
//    reaches the band. The TPU kernel reads p and ds transposed (p^T do,
//    ds^T q); here each thread computes the transposed tiles directly,
//    s^T = K Q^T and dp^T = V dO^T for keys ty + 16i and rows tx + 16j, and
//    stores p^T and ds^T key-major, so the dk/dv products read them exactly
//    as flash_fwd.cu reads P: one broadcast float4 per row, no transposed
//    (bank-conflicting) column reads. dk and dv accumulate in registers.
// Row strides are padded (hd + 4, 64 + 16 floats) so that the lanes of each
// LDS.128 phase hit distinct banks or one broadcast address. The TPU kernels
// cut blocks with divisor_block, which degrades to 1-row blocks for a prime
// S; here tiles are fixed and both ragged tails are masked in the kernels.
//
// Layout: q and do (B,H,Sq,HD), k and v (B,H,Sk,HD), contiguous, f32 or
// bf16 (one dtype), HD in {16, 32, 64, 128}; lse and delta (B,H,Sq) f32;
// dq (B,H,Sq,HD), dk and dv (B,H,Sk,HD) f32. Causal and lowp are runtime
// flags, so there are 2 dtypes x 4 head dims instantiations of each kernel.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of (ty, tx)
constexpr int kPRow = kBK + 16;    // ds / p^T row stride: a warp's two rows on opposite bank halves

__device__ __forceinline__ float dot_in(float x, bool lowp) {
  return lowp ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// four consecutive elements of a global row as floats (16- or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int BH, Sq, Sk, causal, q_offset;
  float scale;
  int lowp;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t bytes = smem_floats(HD) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, HD>;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.BH);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (float*)a.out0, a.Sq, a.Sk,
      a.causal, a.q_offset, a.scale, a.lowp);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t bytes = smem_floats(HD) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, HD>;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.BH);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (float*)a.out0, (float*)a.out1,
      a.Sq, a.Sk, a.causal, a.q_offset, a.scale, a.lowp);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1, int B,
        int H, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
        int is_bf16, int lowp, int device, void* stream) {
  if (B * H > 65535 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, dout, lse, delta, out0, out1, B * H, Sq, Sk, causal,
               q_offset, scale, lowp, (cudaStream_t)stream};
  err = is_bf16 ? dispatch_hd<DQ, __nv_bfloat16>(a, hd) : dispatch_hd<DQ, float>(a, hd);
  return (int)err;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not built for.
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
