// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/rmsnorm.py, the forward
// and backward of its _rmsnorm2d custom_vjp:
//   rmsnorm_fwd  <- _rmsnorm_kernel:      y = x * r * scale,
//                   r = rsqrt(mean(x^2) + eps), the statistic in f32, y in
//                   x's dtype;
//   rmsnorm_bwd  <- _rmsnorm_bwd_kernel:  with gs = g * scale,
//                   dx = r * gs - x * r^3 * mean(gs * x) in x's dtype, and
//                   dscale = sum over rows of g * x * r from f32 partials,
//                   one row of d a block, which the grid then sums (where
//                   the reference's wrapper sums its per-tile ones).
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
// - Backward: the forward's design with two tensors a row. Each row's x and
//   g are read from device memory once and held in registers between the two
//   reductions (sum(x^2) and sum(gs * x), taken together) and the write of
//   dx. The row's length picks the work split (kernels/rmsnorm.bwd_plan): a
//   group of 1-32 threads a row for rows of up to 128 vectors, a block of
//   256 beyond, each thread holding up to 8 vectors of each tensor (the
//   forward's 16 of one); rows past that are read twice. Loads and stores
//   are 16 bytes where d and the pointers allow. The wrapper's grid is a
//   fixed number of blocks an SM, each walking rows; a thread holding at
//   most 2 vectors of each issues the next row's loads before this row's
//   reductions. Each thread keeps its columns' g * x * r partial in
//   registers across all the rows its block takes; a block of groups sums
//   its groups' partials in shared memory in group order, and each block
//   writes one row of partials, so they are (blocks, d), not (rows / 8, d).
//   The grid is launched cooperatively (every block resident), so after
//   one grid-wide barrier each block sums a slice of the columns over all
//   the blocks' rows (row slices a thread, merged in slice order) and
//   writes dscale in scale's dtype: one launch, where the wrapper's
//   sum(0) of the partials took 6.6 us of device time at 4096 x 2048, and
//   a merge by the last block to arrive doubled the call's time (PERF.md,
//   section 6). Every sum runs in a fixed order, so the result is
//   deterministic. scale is read in its own dtype (f32 or bf16), as in the
//   forward.
//
// Layout: x, g, y, dx (rows, d) contiguous, f32 or bf16; scale and dscale
// (d,) f32 or bf16; the partials (blocks, d) f32. The kernels allocate
// nothing and launch on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may use: the card's 232448 bytes less the
// backward's static arrays (warp sums, the column merge's row slices)
constexpr int kMaxDynSmem = 232448 - 4 * kWarps * 4 - kThreads * 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// The backward: dx = r * gs - x * r^3 * mean(gs * x) and the block's
// partial of dscale = sum over its rows of g * x * r, a group of tpr threads
// a row (tpr = 1 << tpr_log2 <= 32, or the whole block when BLOCK). NV > 0:
// each thread holds NV packs of VW elements of x and of g in registers, as
// loaded, across both reductions and the write of dx, and the g * x * r
// partial of its columns across all the block's rows; NV <= 2 issues the
// next row's loads before this row's reductions. scale is read once a block
// as f32, into registers (at most 16 elements a thread) or shared memory.
// NV == 0 (a block a row, rows past the registers): the row is read twice,
// scale from global memory, and the partial row accumulates in place.
template <typename T, int VW, int NV, bool BLOCK>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scale_bf16,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                   void* __restrict__ dscale, int dscale_bf16, int rows, int d, float eps,
                   int tpr_log2) {
  using P = Pack<T, VW>;
  constexpr int NR = NV > 0 ? NV : 1;
  constexpr bool kAhead = NV > 0 && NV <= 2;
  constexpr bool kScaleRegs = NV > 0 && NV * VW <= 16;
  extern __shared__ float4 smem4[];
  // [d] scale past the registers, then (groups) [groups][d] column partials
  float* s_scale = reinterpret_cast<float*>(smem4);
  float* s_cols = s_scale + (NV > 0 && !kScaleRegs ? d : 0);
  __shared__ float s_part[2][2][kWarps];  // BLOCK: warp sums (x^2, gs x), by row parity

  const int tpr = BLOCK ? kThreads : 1 << tpr_log2;
  const int groups = BLOCK ? 1 : kThreads >> tpr_log2;  // rows a block works on at once
  const int lane = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (tpr - 1);
  const int group = BLOCK ? 0 : (int)threadIdx.x >> tpr_log2;
  const unsigned gmask =
      tpr >= 32 ? kFull : ((1u << tpr) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(tpr - 1));
  const int nvec = d / VW;
  const int stride = gridDim.x * groups;
  float* prt = part + (size_t)blockIdx.x * d;  // the block's row of partials

  P xv[NR], gv[NR], xn[kAhead ? NR : 1], gn[kAhead ? NR : 1];
  auto load_row = [&](P (&xd)[NR], P (&gd)[NR], int row) {
    const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
    const P* gr = reinterpret_cast<const P*>(g + (size_t)row * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * tpr + lane;
      if (i < nvec) {
        xd[j] = xr[i];
        gd[j] = gr[i];
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) xd[j].v[e] = gd[j].v[e] = T(0.f);
      }
    }
  };
  int row = blockIdx.x * groups + group;
  if constexpr (NV > 0) {
    if (row < rows) load_row(xv, gv, row);
  }
  float sc[kScaleRegs ? NV : 1][VW];
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
  } else {
    for (int i = lane; i < nvec; i += tpr)  // NV == 0: this thread's own columns
#pragma unroll
      for (int e = 0; e < VW; ++e) prt[i * VW + e] = 0.f;
  }
  const auto scale_of = [&](int j, int e, int i) -> float {
    if constexpr (kScaleRegs) return sc[j][e];
    else return s_scale[i];
  };
  float acc[NR][VW];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[j][e] = 0.f;

  int parity = 0;
  for (; row < rows; row += stride) {
    const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
    const P* gr = reinterpret_cast<const P*>(g + (size_t)row * d);
    P* dr = reinterpret_cast<P*>(dx + (size_t)row * d);
    if constexpr (kAhead) {
      if (row + stride < rows) load_row(xn, gn, row + stride);
    }
    float ss = 0.f, dot = 0.f;  // sum(x^2), sum(gs * x)
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xf = to_f32(xv[j].v[e]);
          const float gs = to_f32(gv[j].v[e]) * scale_of(j, e, (j * tpr + lane) * VW + e);
          ss = fmaf(xf, xf, ss);
          dot = fmaf(gs, xf, dot);
        }
    } else {
      for (int i = lane; i < nvec; i += tpr) {
        const P xp = xr[i], gp = gr[i];
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xf = to_f32(xp.v[e]);
          const float gs = to_f32(gp.v[e]) * scale_at(scale, scale_bf16, i * VW + e);
          ss = fmaf(xf, xf, ss);
          dot = fmaf(gs, xf, dot);
        }
      }
    }
    if constexpr (BLOCK) {
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      if ((threadIdx.x & 31) == 0) {
        s_part[parity][0][threadIdx.x >> 5] = ss;
        s_part[parity][1][threadIdx.x >> 5] = dot;
      }
      __syncthreads();
      ss = dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ss += s_part[parity][0][w];
        dot += s_part[parity][1][w];
      }
      parity ^= 1;
    } else {
      for (int o = tpr >> 1; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(gmask, ss, o);
        dot += __shfl_xor_sync(gmask, dot, o);
      }
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float k = r * r * r * (dot / (float)d);
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + lane;
        if (i < nvec) {
          P out;
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float xf = to_f32(xv[j].v[e]), gf = to_f32(gv[j].v[e]);
            from_f32(&out.v[e], r * (gf * scale_of(j, e, i * VW + e)) - xf * k);
            acc[j][e] = fmaf(gf * xf, r, acc[j][e]);
          }
          dr[i] = out;
        }
      }
      if constexpr (kAhead) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          xv[j] = xn[j];
          gv[j] = gn[j];
        }
      } else if (row + stride < rows) {
        load_row(xv, gv, row + stride);
      }
    } else {
      for (int i = lane; i < nvec; i += tpr) {
        const P xp = xr[i], gp = gr[i];
        P out;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xf = to_f32(xp.v[e]), gf = to_f32(gp.v[e]);
          from_f32(&out.v[e], r * (gf * scale_at(scale, scale_bf16, i * VW + e)) - xf * k);
          prt[i * VW + e] = fmaf(gf * xf, r, prt[i * VW + e]);
        }
        dr[i] = out;
      }
    }
  }

  // the block's row of dscale partials
  if constexpr (NV > 0) {
    if constexpr (BLOCK) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + lane;
        if (i < nvec) {
#pragma unroll
          for (int e = 0; e < VW; ++e) prt[i * VW + e] = acc[j][e];
        }
      }
    } else {  // the groups' partials, summed in group order
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + lane;
        if (i < nvec) {
#pragma unroll
          for (int e = 0; e < VW; ++e) s_cols[group * d + i * VW + e] = acc[j][e];
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float sum = 0.f;
        for (int q = 0; q < groups; ++q) sum += s_cols[q * d + c];
        prt[c] = sum;
      }
    }
  }

  // every block's row of partials is in: block b sums columns [c0, c1) over
  // all the rows, a thread taking every slices-th row of one column
  __shared__ float s_slices[kThreads];  // [slice][column]
  cooperative_groups::this_grid().sync();
  const int nb = (int)gridDim.x;
  const int cpb = (d + nb - 1) / nb;  // columns a block sums
  const int c0 = (int)blockIdx.x * cpb, c1 = min(c0 + cpb, d);
  const auto put = [&](int c, float v) {
    if (dscale_bf16)
      static_cast<__nv_bfloat16*>(dscale)[c] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(dscale)[c] = v;
  };
  if (cpb >= kThreads) {
    for (int c = c0 + (int)threadIdx.x; c < c1; c += kThreads) {
      float sum = 0.f;
      for (int b = 0; b < nb; ++b) sum += __ldcg(part + (size_t)b * d + c);
      put(c, sum);
    }
  } else {
    const int slices = kThreads / cpb;
    const int col = (int)threadIdx.x % cpb, slice = (int)threadIdx.x / cpb;
    float sum = 0.f;
    if (slice < slices && c0 + col < c1) {
#pragma unroll 4
      for (int b = slice; b < nb; b += slices) sum += __ldcg(part + (size_t)b * d + c0 + col);
    }
    s_slices[threadIdx.x] = sum;
    __syncthreads();
    if ((int)threadIdx.x < cpb && c0 + (int)threadIdx.x < c1) {
      float total = 0.f;
      for (int q = 0; q < slices; ++q) total += s_slices[q * cpb + threadIdx.x];
      put(c0 + threadIdx.x, total);
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

// bytes of dynamic shared memory of a backward block: scale past the
// registers, and a block of groups' column partials
size_t bwd_smem(int d, int vec, int tpr, int nv) {
  const bool scale_regs = nv > 0 && nv * vec <= 16;
  size_t floats = nv > 0 && !scale_regs ? (size_t)d : 0;
  if (nv > 0 && tpr < kThreads) floats += (size_t)(kThreads / tpr) * d;
  return floats * sizeof(float);
}

// A cooperative launch (every block resident, for the grid-wide barrier):
// `blocks` blocks, or as many as the card holds at once where that is fewer
// (the rows and the partials follow gridDim.x).
template <typename T, int VW, int NV, bool BLOCK>
cudaError_t bwd_launch(const void* x, const void* scale, int scale_bf16, const void* g,
                       void* dx, float* part, void* dscale, int dscale_bf16, int rows, int d,
                       float eps, int tpr, int tpr_log2, int blocks, int device,
                       cudaStream_t s) {
  auto kernel = rmsnorm_bwd_kernel<T, VW, NV, BLOCK>;
  const size_t smem = bwd_smem(d, VW, tpr, NV);
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocks_per_sm(kernel, device, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  const T *xt = (const T*)x, *gt = (const T*)g;
  T* dxt = (T*)dx;
  void* args[] = {(void*)&xt,      (void*)&scale,       (void*)&scale_bf16, (void*)&gt,
                  (void*)&dxt,     (void*)&part,        (void*)&dscale,     (void*)&dscale_bf16,
                  (void*)&rows,    (void*)&d,           (void*)&eps,        (void*)&tpr_log2};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
                                     s);
}

template <typename T, int VW>
cudaError_t bwd_vw(const void* x, const void* scale, int scale_bf16, const void* g, void* dx,
                   float* part, void* dscale, int dscale_bf16, int rows, int d, float eps,
                   int tpr, int nv, int blocks, int device, cudaStream_t s) {
#define RMS_BWD(N, BLK) \
  bwd_launch<T, VW, N, BLK>(x, scale, scale_bf16, g, dx, part, dscale, dscale_bf16, rows, d, \
                            eps, tpr, lg, blocks, device, s)
  // a group of up to 32 threads a row holds 1, 2 or 4 vectors of each
  // tensor a thread (the caller's plan); a block a row 1-8, or reads its
  // row twice (0)
  if (tpr == kThreads) {
    const int lg = 0;
    switch (nv) {
      case 0: return RMS_BWD(0, true);
      case 1: return RMS_BWD(1, true);
      case 2: return RMS_BWD(2, true);
      case 4: return RMS_BWD(4, true);
      case 8: return RMS_BWD(8, true);
      default: return cudaErrorInvalidValue;
    }
  }
  int lg = 0;
  while ((1 << lg) < tpr) ++lg;
  if ((1 << lg) != tpr || tpr > 32) return cudaErrorInvalidValue;
  switch (nv) {
    case 1: return RMS_BWD(1, false);
    case 2: return RMS_BWD(2, false);
    case 4: return RMS_BWD(4, false);
    default: return cudaErrorInvalidValue;
  }
#undef RMS_BWD
}

template <typename T>
cudaError_t bwd_t(const void* x, const void* scale, int scale_bf16, const void* g, void* dx,
                  float* part, void* dscale, int dscale_bf16, int rows, int d, float eps,
                  int vec, int tpr, int nv, int blocks, int device, cudaStream_t s) {
#define RMS_BWD_VW(W) \
  bwd_vw<T, W>(x, scale, scale_bf16, g, dx, part, dscale, dscale_bf16, rows, d, eps, tpr, nv, \
               blocks, device, s)
  switch (vec) {
    case 1: return RMS_BWD_VW(1);
    case 4: return RMS_BWD_VW(4);
    case 8:  // 16 bytes of bf16
      if constexpr (sizeof(T) == 2) return RMS_BWD_VW(8);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef RMS_BWD_VW
}

}  // namespace

extern "C" {

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

// rmsnorm_bwd: the same row shape (kernels/rmsnorm.bwd_plan: tpr 1-32 with
// nv 1, 2 or 4, or 256 with nv 1, 2, 4, 8 or 0), x, g and dx aligned to vec
// elements, scale and dscale f32 or bf16 (scale_bf16, dscale_bf16); up to
// `blocks` blocks walk the rows (fewer where the card holds fewer at once),
// and part holds (blocks, d) floats of scratch for their partials.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx, void* part,
                void* dscale, int rows, int d, float eps, int is_bf16, int scale_bf16,
                int dscale_bf16, int vec, int tpr, int nv, int blocks, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || d <= 0 || vec <= 0 || d % vec || blocks <= 0 ||
      (nv > 0 && (long long)tpr * nv * vec < d) || (nv == 0 && tpr != kThreads) ||
      bwd_smem(d, vec, tpr, nv) > (size_t)kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)part;
  err = is_bf16 ? bwd_t<__nv_bfloat16>(x, scale, scale_bf16, g, dx, p, dscale, dscale_bf16,
                                        rows, d, eps, vec, tpr, nv, blocks, device, s)
                : bwd_t<float>(x, scale, scale_bf16, g, dx, p, dscale, dscale_bf16, rows, d,
                               eps, vec, tpr, nv, blocks, device, s);
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
