// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/rmsnorm.py, the forward
// and backward of its _rmsnorm2d custom_vjp:
//   rmsnorm_fwd  <- _rmsnorm_kernel:      y = x * r * scale,
//                   r = rsqrt(mean(x^2) + eps), the statistic in f32, y in
//                   x's dtype;
//   rmsnorm_bwd  <- _rmsnorm_bwd_kernel:  with gs = g * scale,
//                   dx = r * gs - x * r^3 * mean(gs * x) in x's dtype, and
//                   f32 partials of dscale = sum over rows of g * x * r, one
//                   row of d partials per block of rows, which the caller
//                   sums (as the reference's wrapper sums its per-tile ones).
//
// What bounds them on the H100: a handful of FLOPs per element against 4 or
// 2 bytes read and written, far below the ~20 FLOP/byte at which f32
// CUDA-core work would take over from the 3.35 TB/s of device memory: both
// are bound by bytes (forward: read x, write y; backward: read x and g,
// write dx).
//
// What the designs do about it:
// - Forward: one warp per row, 8 rows per 256-thread block. The warp sums
//   x^2 over its row (lanes stride the row, 16-byte loads when d % 4 == 0
//   and the rows are aligned, scalars otherwise), reduces by shuffles, then
//   reads the row again, now from L1, to scale and store it. Any d works.
// - Backward: 8 rows per block. Phase 1: warp w reduces row w's sum(x^2) and
//   sum(g * scale * x) and leaves r and r^3 * mean(gs * x) in shared memory.
//   Phase 2: the threads run along the columns (again 4 at a time where
//   aligned), walk the block's rows (from L1 and L2) writing dx and keep
//   each column's dscale partial in a register, written once per block. The
//   partials are summed in a fixed order, so the result is deterministic.
//
// Layout: x, g, y, dx (rows, d) contiguous, f32 or bf16; scale (d,) f32;
// dscale partials (ceil(rows / 8), d) f32. The kernels allocate nothing and
// launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps;  // forward: a warp per row; backward: the same rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Four neighbouring elements at p (16 bytes of f32, 8 of bf16), as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (long long)row * d;
  T* yr = y + (long long)row * d;
  float ss = 0.f;
  if (VEC) {
    for (int i = lane * 4; i < d; i += 128) {
      const float4 v = load4(xr + i);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
  if (VEC) {
    for (int i = lane * 4; i < d; i += 128) {
      const float4 v = load4(xr + i);
      const float4 s = *reinterpret_cast<const float4*>(scale + i);
      store4(yr + i, make_float4(v.x * r * s.x, v.y * r * s.y, v.z * r * s.z,
                                 v.w * r * s.w));
    }
  } else {
    for (int i = lane; i < d; i += 32) store(yr + i, to_f32(xr[i]) * r * scale[i]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ dscale_part, int rows, int d, float eps) {
  __shared__ float s_r[kRowsPerBlock];
  __shared__ float s_k[kRowsPerBlock];  // r^3 * mean(gs * x)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, rows - row0);

  // phase 1: the row statistics, a warp per row
  if (warp < nrows) {
    const T* xr = x + (long long)(row0 + warp) * d;
    const T* gr = g + (long long)(row0 + warp) * d;
    float ss = 0.f, dot = 0.f;
    if (VEC) {
      for (int i = lane * 4; i < d; i += 128) {
        const float4 xv = load4(xr + i), gv = load4(gr + i);
        const float4 s = *reinterpret_cast<const float4*>(scale + i);
        ss += xv.x * xv.x + xv.y * xv.y + xv.z * xv.z + xv.w * xv.w;
        dot += gv.x * s.x * xv.x + gv.y * s.y * xv.y + gv.z * s.z * xv.z +
               gv.w * s.w * xv.w;
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xv = to_f32(xr[i]);
        ss += xv * xv;
        dot += to_f32(gr[i]) * scale[i] * xv;
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float r = rsqrtf(ss / (float)d + eps);
      s_r[warp] = r;
      s_k[warp] = r * r * r * (dot / (float)d);
    }
  }
  __syncthreads();

  // phase 2: dx and the dscale partials, threads along the columns
  float* part = dscale_part + (long long)blockIdx.x * d;
  if (VEC) {
    for (int i = threadIdx.x * 4; i < d; i += kThreads * 4) {
      const float4 s = *reinterpret_cast<const float4*>(scale + i);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < nrows; ++j) {
        const long long off = (long long)(row0 + j) * d + i;
        const float4 xv = load4(x + off), gv = load4(g + off);
        const float r = s_r[j], k = s_k[j];
        store4(dx + off, make_float4(r * (gv.x * s.x) - xv.x * k,
                                     r * (gv.y * s.y) - xv.y * k,
                                     r * (gv.z * s.z) - xv.z * k,
                                     r * (gv.w * s.w) - xv.w * k));
        acc.x += gv.x * xv.x * r;
        acc.y += gv.y * xv.y * r;
        acc.z += gv.z * xv.z * r;
        acc.w += gv.w * xv.w * r;
      }
      *reinterpret_cast<float4*>(part + i) = acc;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float s = scale[i];
      float acc = 0.f;
      for (int j = 0; j < nrows; ++j) {
        const long long off = (long long)(row0 + j) * d + i;
        const float xv = to_f32(x[off]), gv = to_f32(g[off]);
        const float r = s_r[j];
        store(dx + off, r * (gv * s) - xv * s_k[j]);
        acc += gv * xv * r;
      }
      part[i] = acc;
    }
  }
}

template <typename T>
cudaError_t fwd_t(const void* x, const float* scale, void* y, int rows, int d,
                  float eps, int vec, cudaStream_t s) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    rmsnorm_fwd_kernel<T, true><<<blocks, kThreads, 0, s>>>((const T*)x, scale, (T*)y,
                                                            rows, d, eps);
  else
    rmsnorm_fwd_kernel<T, false><<<blocks, kThreads, 0, s>>>((const T*)x, scale, (T*)y,
                                                             rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const void* x, const float* scale, const void* g, void* dx,
                  float* part, int rows, int d, float eps, int vec, cudaStream_t s) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    rmsnorm_bwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        (const T*)x, scale, (const T*)g, (T*)dx, part, rows, d, eps);
  else
    rmsnorm_bwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        (const T*)x, scale, (const T*)g, (T*)dx, part, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block of the backward: the caller allocates
// ceil(rows / rmsnorm_rows_per_block()) rows of dscale partials.
int rmsnorm_rows_per_block() { return kRowsPerBlock; }

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernels do not take. ``vec``
// selects the 4-wide loads: the caller passes 1 only when d % 4 == 0 and
// every pointer is aligned to 4 elements.
int rmsnorm_fwd(const void* x, const void* scale, void* y, int rows, int d, float eps,
                int is_bf16, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || d <= 0 || (vec && d % 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = is_bf16 ? fwd_t<__nv_bfloat16>(x, (const float*)scale, y, rows, d, eps, vec, s)
                : fwd_t<float>(x, (const float*)scale, y, rows, d, eps, vec, s);
  return (int)err;
}

int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                void* dscale_part, int rows, int d, float eps, int is_bf16, int vec,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || d <= 0 || (vec && d % 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)dscale_part;
  err = is_bf16 ? bwd_t<__nv_bfloat16>(x, (const float*)scale, g, dx, part, rows, d,
                                        eps, vec, s)
                : bwd_t<float>(x, (const float*)scale, g, dx, part, rows, d, eps, vec, s);
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
