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
// - Forward: each row is read from device memory once and held in
//   registers between the statistic and the scaling; y is written once.
//   The row's length picks the work split (kernels/rmsnorm.fwd_plan): rows
//   of up to 64 vectors take a group of 1-32 threads (several rows a warp
//   when short), longer ones a block of 256 threads that sums its warps'
//   partials in shared memory, each thread holding up to 16 vectors. Loads
//   and stores are 16 bytes (8 bf16, 4 f32) where d and the pointers allow,
//   else 4 elements, else scalars. Blocks walk rows until every row is
//   done, one wave on the card; a thread holding at most 8 vectors issues
//   the next row's loads before this row's reduction, so each SM keeps
//   loads in flight between rows. scale is read in its own dtype (f32 or
//   bf16, converted exactly) into shared memory once a block, after the
//   first row's loads have gone out. Rows past what the registers hold
//   (more than 16 vectors a thread) are read twice, by a block each.
// - Backward: 8 rows per block. Phase 1: warp w reduces row w's sum(x^2) and
//   sum(g * scale * x) and leaves r and r^3 * mean(gs * x) in shared memory.
//   Phase 2: the threads run along the columns (again 4 at a time where
//   aligned), walk the block's rows (from L1 and L2) writing dx and keep
//   each column's dscale partial in a register, written once per block. The
//   partials are summed in a fixed order, so the result is deterministic.
//
// Layout: x, g, y, dx (rows, d) contiguous, f32 or bf16; scale (d,) f32, or
// bf16 for the forward; dscale partials (ceil(rows / 8), d) f32. The kernels
// allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps;  // backward: rows a block
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may use: the card's 232448 bytes less the
// forward's static warp sums
constexpr int kMaxDynSmem = 232448 - 2 * kWarps * 4;

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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// VW neighbouring elements of a row, loaded and stored as one access (16
// bytes for f32 x 4 and bf16 x 8, 8 bytes for bf16 x 4)
template <typename T, int VW>
struct alignas(VW * sizeof(T)) Pack {
  T v[VW];
};

__device__ __forceinline__ float scale_at(const void* scale, int scale_bf16, int i) {
  return scale_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[i])
                    : static_cast<const float*>(scale)[i];
}

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// y = x * rsqrt(mean(x^2) + eps) * scale, a group of tpr threads a row
// (tpr = 1 << tpr_log2 <= 32, or the whole block when BLOCK). NV > 0: each
// thread holds NV packs of VW elements of its row in registers, as loaded,
// between the statistic and the scaling, so x is read once; the first row's
// loads go out before scale is read (as f32, once a block: into registers,
// or into shared memory past 4 vectors a thread), and each next row's
// before this row's reduction. NV == 0 (rows past the registers): the row
// is read twice and scale from global memory.
template <typename T, int VW, int NV, bool BLOCK>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scale_bf16,
                   T* __restrict__ y, int rows, int d, float eps, int tpr_log2) {
  using P = Pack<T, VW>;
  extern __shared__ float4 smem4[];
  float* s_scale = reinterpret_cast<float*>(smem4);  // [d], NV > 4
  __shared__ float s_part[2][kWarps];                 // BLOCK: warp sums, by row parity

  const int tpr = BLOCK ? kThreads : 1 << tpr_log2;
  const int groups = BLOCK ? 1 : kThreads >> tpr_log2;  // rows a block works on at once
  const int lane = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (tpr - 1);
  const int group = BLOCK ? 0 : (int)threadIdx.x >> tpr_log2;
  // the lanes of this thread's group within its warp, for the shuffles
  const unsigned gmask =
      tpr >= 32 ? kFull : ((1u << tpr) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(tpr - 1));
  const int nvec = d / VW;
  const int stride = gridDim.x * groups;

  // NV <= 8: the next row's loads go out before this row's reduction, into
  // a second set of registers; more would cost occupancy. NV <= 4: each
  // thread keeps its own scale elements in registers (the same for every
  // row it takes), with no shared memory and no block barrier before the
  // first row; more vectors read scale from shared memory.
  constexpr bool kAhead = NV > 0 && NV <= 8;
  constexpr bool kScaleRegs = NV > 0 && NV <= 4;
  P v[NV > 0 ? NV : 1], vn[kAhead ? NV : 1];
  auto load_row = [&](P (&dst)[NV > 0 ? NV : 1], int row) {
    const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * tpr + lane;
      if (i < nvec) {
        dst[j] = xr[i];
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) dst[j].v[e] = T(0.f);
      }
    }
  };
  int row = blockIdx.x * groups + group;
  float sc[kScaleRegs ? NV : 1][VW];
  if constexpr (NV > 0) {
    if (row < rows) load_row(v, row);
  }
  if constexpr (kScaleRegs) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int i = (j * tpr + lane) * VW + e;
        sc[j][e] = i < d ? scale_at(scale, scale_bf16, i) : 0.f;
      }
  } else if constexpr (NV > 0) {
    for (int i = threadIdx.x; i < d; i += kThreads) s_scale[i] = scale_at(scale, scale_bf16, i);
    __syncthreads();
  }
  int parity = 0;
  for (; row < rows; row += stride) {
    const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
    P* yr = reinterpret_cast<P*>(y + (size_t)row * d);
    if constexpr (kAhead) {
      if (row + stride < rows) load_row(vn, row + stride);
    }
    float ss = 0.f;
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float f = to_f32(v[j].v[e]);
          ss = fmaf(f, f, ss);
        }
    } else {
      for (int i = lane; i < nvec; i += tpr) {
        const P pk = xr[i];
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float f = to_f32(pk.v[e]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    if constexpr (BLOCK) {
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) s_part[parity][threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ss += s_part[parity][w];
      parity ^= 1;
    } else {
      for (int o = tpr >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(gmask, ss, o);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + lane;
        if (i < nvec) {
          P out;
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            float sv;
            if constexpr (kScaleRegs)
              sv = sc[j][e];
            else
              sv = s_scale[i * VW + e];
            from_f32(&out.v[e], to_f32(v[j].v[e]) * r * sv);
          }
          yr[i] = out;
        }
      }
      if constexpr (kAhead) {
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = vn[j];
      } else if (row + stride < rows) {
        load_row(v, row + stride);
      }
    } else {
      for (int i = lane; i < nvec; i += tpr) {
        const P pk = xr[i];
        P out;
#pragma unroll
        for (int e = 0; e < VW; ++e)
          from_f32(&out.v[e], to_f32(pk.v[e]) * r * scale_at(scale, scale_bf16, i * VW + e));
        yr[i] = out;
      }
    }
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

// Blocks of `kernel` one SM holds with `smem` bytes of dynamic shared memory
// and the device's SM count, asked once per (device, kernel, smem): the two
// queries and the shared-memory attribute would cost host time on every
// launch. The attribute only ever rises, so a launch with less shared
// memory stays valid. A thread-safe table, as the wrappers may be called
// from several threads.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int device, size_t smem, int* per_sm, int* sms) {
  struct Entry {
    int device;
    const void* fn;
    size_t smem;
    int per_sm, sms;
  };
  static std::mutex mu;
  static std::vector<Entry> table;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t attr = 0;  // the attribute as set so far (static bytes count against 48 KB)
  for (const Entry& e : table) {
    if (e.device == device && e.fn == fn && e.smem == smem) {
      *per_sm = e.per_sm;
      *sms = e.sms;
      return cudaSuccess;
    }
    if (e.device == device && e.fn == fn && e.smem > attr) attr = e.smem;
  }
  cudaError_t err;
  if ((smem > attr && (err = cudaFuncSetAttribute(kernel,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  (int)smem)) != cudaSuccess) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  table.push_back({device, fn, smem, *per_sm, *sms});
  return cudaSuccess;
}

template <typename T, int VW, int NV, bool BLOCK>
cudaError_t fwd_launch(const void* x, const void* scale, int scale_bf16, void* y, int rows,
                       int d, float eps, int tpr_log2, int device, cudaStream_t s) {
  auto kernel = rmsnorm_fwd_kernel<T, VW, NV, BLOCK>;
  const size_t smem = NV > 4 ? (size_t)d * sizeof(float) : 0;  // scale, beyond registers
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocks_per_sm(kernel, device, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM once, each walking its rows
  const int groups = BLOCK ? 1 : kThreads >> tpr_log2;
  const long long need = ((long long)rows + groups - 1) / groups;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < fill ? need : fill);
  kernel<<<blocks, kThreads, smem, s>>>((const T*)x, scale, scale_bf16, (T*)y, rows, d, eps,
                                        tpr_log2);
  return cudaGetLastError();
}

template <typename T, int VW, bool BLOCK>
cudaError_t fwd_nv(const void* x, const void* scale, int scale_bf16, void* y, int rows, int d,
                   float eps, int tpr_log2, int nv, int device, cudaStream_t s) {
#define RMS_FWD(N) \
  fwd_launch<T, VW, N, BLOCK>(x, scale, scale_bf16, y, rows, d, eps, tpr_log2, device, s)
  // a group of up to 32 threads a row holds 1-2 vectors a thread (the
  // caller's plan); a block a row 1-16, or reads its row twice (0)
  if constexpr (BLOCK) {
    switch (nv) {
      case 0: return RMS_FWD(0);
      case 1: return RMS_FWD(1);
      case 2: return RMS_FWD(2);
      case 4: return RMS_FWD(4);
      case 8: return RMS_FWD(8);
      case 16: return RMS_FWD(16);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (nv) {
      case 1: return RMS_FWD(1);
      case 2: return RMS_FWD(2);
      default: return cudaErrorInvalidValue;
    }
  }
#undef RMS_FWD
}

template <typename T, int VW>
cudaError_t fwd_vw(const void* x, const void* scale, int scale_bf16, void* y, int rows, int d,
                   float eps, int tpr, int nv, int device, cudaStream_t s) {
  if (tpr == kThreads)
    return fwd_nv<T, VW, true>(x, scale, scale_bf16, y, rows, d, eps, 0, nv, device, s);
  int lg = 0;
  while ((1 << lg) < tpr) ++lg;
  if ((1 << lg) != tpr || tpr > 32) return cudaErrorInvalidValue;
  return fwd_nv<T, VW, false>(x, scale, scale_bf16, y, rows, d, eps, lg, nv, device, s);
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* scale, int scale_bf16, void* y, int rows, int d,
                  float eps, int vec, int tpr, int nv, int device, cudaStream_t s) {
  switch (vec) {
    case 1: return fwd_vw<T, 1>(x, scale, scale_bf16, y, rows, d, eps, tpr, nv, device, s);
    case 4: return fwd_vw<T, 4>(x, scale, scale_bf16, y, rows, d, eps, tpr, nv, device, s);
    case 8:  // 16 bytes of bf16
      if constexpr (sizeof(T) == 2)
        return fwd_vw<T, 8>(x, scale, scale_bf16, y, rows, d, eps, tpr, nv, device, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
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
// every pointer the kernel reads 4 at a time is aligned to 4 elements.
//
// rmsnorm_fwd: scale in its own dtype (f32, or bf16 with scale_bf16); the
// row shape from the caller (kernels/rmsnorm.fwd_plan): loads of `vec`
// elements (1, 4, or 8 for bf16; the caller passes more than 1 only when d
// is a multiple and x and y are aligned to vec elements), tpr threads a row
// (1-32, a power of 2, or 256 for a block a row), each holding nv vectors
// (1 or 2 in a group; 1, 2, 4, 8 or 16 in a block, or 0 for a block that
// reads its row twice). The plan must cover the row: d <= tpr * nv * vec
// unless nv is 0.
int rmsnorm_fwd(const void* x, const void* scale, void* y, int rows, int d, float eps,
                int is_bf16, int scale_bf16, int vec, int tpr, int nv, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || d <= 0 || vec <= 0 || d % vec ||
      (nv > 0 && (long long)tpr * nv * vec < d) ||
      (nv > 4 && (size_t)d * sizeof(float) > (size_t)kMaxDynSmem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = is_bf16 ? fwd_t<__nv_bfloat16>(x, scale, scale_bf16, y, rows, d, eps, vec, tpr, nv,
                                        device, s)
                : fwd_t<float>(x, scale, scale_bf16, y, rows, d, eps, vec, tpr, nv, device, s);
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
