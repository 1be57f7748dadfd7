// Depthwise kh x kw convolution for Hopper (sm_90a), NHWC, stride 1, SAME.
//
// Replaces the TPU kernel src/repro/kernels/depthwise_conv.py::_dw_kernel
// (called through depthwise_conv): out[b,h,w,c] = sum over taps (a, t) of
// x[b, h+a-ph, w+t-pw, c] * wt[a, t, c], with ph = (kh-1)/2, pw = (kw-1)/2,
// taps outside the image counting as zero, summed in f32 in tap order (rows,
// then columns) and stored in x's dtype. Forward only: the reference has no
// gradient for it either.
//
// What bounds it on the H100: each output element takes kh*kw FMAs (9 for a
// 3x3) on inputs it shares with its neighbours, so the function moves one
// read of x, one write of out and the small weight tensor: about 1 FMA per
// 4-byte element read and written, far below the ~20 FLOP/byte at which f32
// CUDA-core work would take over from the 3.35 TB/s of device memory. It is
// bound by bytes.
//
// What the design does about it: a block owns one tile of CT channels and
// walks a strided list of (b, TH output rows, TW output columns) items of
// that channel tile, so it reads its weights once: into registers for a
// kernel of 3 rows (every depthwise layer of the paper's CNNs), into shared
// memory as f32 for any other height. Each item's (TH + kh - 1) x (TW + kw - 1) x CT input box goes
// into shared memory once, by asynchronous copy, into one of two stages, so
// the next item's copy is in flight while the current one's FMAs run
// (the first copy goes out before the weights are read):
//  - TMA where the row pitch C * elt and x's base are multiples of 16
//    bytes: one 4-D tensor map (C, W, H, B) and one thread issuing the box;
//    coordinates outside the tensor (negative ones included) read as zeros,
//    so the SAME halo in rows and columns costs no bytes and no code;
//  - cp.async of 16, 8 or 4 bytes, zero-filled outside the image, where the
//    pitch is not a multiple of 16 bytes (ShuffleNetV2's 58 in f32; 58 and
//    116 in bf16) or the base is not aligned;
//  - plain element loads where not even 4 bytes line up (bf16 with odd C).
// No padded copy of x is made. Each thread owns 4 neighbouring channels (one
// 16-byte f32 or 8-byte bf16 vector in shared memory, the tile's channels
// padded to the vector) and a strip of 4 neighbouring output columns of one
// row: per kernel row it loads the strip's 4 + kw - 1 input vectors once and
// reuses them for all kw column taps (4 x kw x 4 FMAs). The store goes out as
// 4-, 2- or 1-channel vectors, whichever C's alignment allows. The block and
// thread indices are decomposed once; an item's (b, row tile, column tile)
// advances by a mixed-radix add and the staging loops divide by a float
// reciprocal, so no thread divides by a runtime value per element. The host
// (kernels/depthwise_conv.depthwise_plan) picks the tile and the copy route;
// small images take a whole image a tile, with more channels a block; in
// bf16 a 3x3 kernel gives a thread 2 output rows where the image has 8 rows
// or more (one input row loaded serves both). The launch fills every SM
// once.
//
// Layout: x (B,H,W,C), wt (kh,kw,C), out (B,H,W,C), contiguous, f32 or bf16,
// kh odd, kw in {1,3,5,7}. The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kVec = 4;    // channels per thread
constexpr int kStrip = 4;  // output columns per thread
constexpr int kStages = 2;  // input boxes a block holds (3 and 4 were slower: more smem a block)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kMaxDynSmem = kMaxSmem - kStages * 8;  // less the static mbarriers
enum Route : int { kRouteTma = 0, kRouteAsync = 1, kRoutePlain = 2 };

struct Params {
  const void* x;
  const void* wt;
  void* out;
  int B, H, W, C, kh, kw;
  int CT, TH, TW;        // a tile: channels, output rows, output columns
  int R;                 // output rows a thread (1, or 2 for a 3-row kernel)
  int n_rt, n_wt;        // row and column tiles of an image
  int P;                 // blocks per channel tile
  int route, copy_bytes, store_vec;
  uint32_t stage_bytes;  // one stage's bytes, a multiple of 128
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four neighbouring channels from shared memory, as floats
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float4& acc, float4 x, float4 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
  acc.z = fmaf(x.z, w.z, acc.z);
  acc.w = fmaf(x.w, w.w, acc.w);
}

// n (1-4) channels at p, as one 4-vector, pairs or scalars (vec: what C's
// alignment allows; n is even when vec is 2 and 4 when vec is 4)
__device__ __forceinline__ void store_out(float* p, float4 v, int n, int vec) {
  if (vec == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else if (vec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v.x, v.y);
    if (n > 2) *reinterpret_cast<float2*>(p + 2) = make_float2(v.z, v.w);
  } else {
    p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float4 v, int n, int vec) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  if (vec == 4) {
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else if (vec == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = a;
    if (n > 2) *reinterpret_cast<__nv_bfloat162*>(p + 2) = b;
  } else {
    p[0] = a.x;
    if (n > 1) p[1] = a.y;
    if (n > 2) p[2] = b.x;
    if (n > 3) p[3] = b.y;
  }
}

// floor(n / d) for 0 <= n < 2^16 and 1 <= d < 2^16 with inv = 1.f / d: the
// float error (a few 2^-24 of n / d) stays below the 0.5 / d margin. The
// staging loops' n stay below 2^16: two stages fit kMaxSmem, so a
// stage holds fewer than 2^16 elements of 2 bytes.
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz(((float)n + 0.5f) * inv);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of some 20 s
// (2^35 cycles) traps, so that a lost arrival fails the launch, not the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one (CT, TW + kw - 1, TH + kh - 1, 1) box of the 4-D tensor map into
// shared memory; coordinates (c, w, h, b) may be negative or past the end
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(b)
      : "memory");
}

// `bytes` (4, 8 or 16) from src, or zeros when src_bytes is 0
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, int src_bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

// Stage one item's input box: rows h0 - ph .. h0 + TH + kh - 2, columns
// w0 - pw .. w0 + TW + kw - 2, channels c0 .. c0 + CT - 1 of image b, as a
// dense [rows][columns][CT] array, zeros outside the tensor.
template <typename T>
__device__ __forceinline__ void stage_load(const Params& p, const CUtensorMap* tm, T* dst,
                                           uint64_t* bar, int b, int h0, int w0, int c0,
                                           int kh, int kw, float inv_wb) {
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int RB = p.TH + kh - 1, WB = p.TW + kw - 1;
  if (p.route == kRouteTma) {
    if (threadIdx.x == 0) {
      // the generic-proxy reads of this stage (ordered by the block barrier
      // before this point) come before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_expect_tx(bar, (uint32_t)(RB * WB * p.CT) * sizeof(T));
      tma_load_4d(dst, tm, bar, c0, w0 - pw, h0 - ph, b);
    }
    return;
  }
  const T* x = (const T*)p.x;
  const int g = p.route == kRouteAsync ? p.copy_bytes / (int)sizeof(T) : 1;  // channels a copy
  const int per_pix = p.CT / g;
  auto copy = [&](int row, int col, int ch) {
    const int h = h0 - ph + row, w = w0 - pw + col, c = c0 + ch;
    const bool in = (unsigned)h < (unsigned)p.H && (unsigned)w < (unsigned)p.W && c < p.C;
    const T* src = in ? x + (((size_t)b * p.H + h) * p.W + w) * p.C + c : x;
    T* d = dst + (size_t)(row * WB + col) * p.CT + ch;
    if (p.route == kRouteAsync)
      cp_async(smem_u32(d), src, p.copy_bytes, in ? p.copy_bytes : 0);
    else
      *d = in ? *src : T(0.f);
  };
  if ((int)blockDim.x % per_pix == 0) {
    // each thread keeps one chunk of a pixel and walks the pixels, its
    // (row, column) advanced by adds
    const int ch = (int)threadIdx.x % per_pix * g, step = (int)blockDim.x / per_pix;
    const int pix = (int)threadIdx.x / per_pix;
    int row = div_small(pix, inv_wb), col = pix - row * WB;
    while (row < RB) {
      copy(row, col, ch);
      col += step;
      if (col >= WB) {
        const int wrap = div_small(col, inv_wb);
        row += wrap;
        col -= wrap * WB;
      }
    }
  } else {
    const float inv_pp = 1.f / (float)per_pix;
    const int total = RB * WB * per_pix;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int pix = div_small(i, inv_pp);
      const int row = div_small(pix, inv_wb);
      copy(row, pix - row * WB, (i - pix * per_pix) * g);
    }
  }
  if (p.route == kRouteAsync) asm volatile("cp.async.commit_group;" ::: "memory");
}

// One input row of a thread's strip: its kStrip + KW - 1 vectors, as f32
template <typename T, int KW>
__device__ __forceinline__ void load_row(float4 (&xv)[kStrip + KW - 1], const T* row, int ct) {
#pragma unroll
  for (int j = 0; j < kStrip + KW - 1; ++j) xv[j] = lds4(row + j * ct);
}

// One kernel row's taps for a thread's strip: acc[o] += x[o + t] * w[t],
// columns in order
template <int KW>
__device__ __forceinline__ void row_taps(float4 (&acc)[kStrip], const float4 (&xv)[kStrip + KW - 1],
                                         const float4 (&w)[KW]) {
#pragma unroll
  for (int t = 0; t < KW; ++t)
#pragma unroll
    for (int o = 0; o < kStrip; ++o) fma4(acc[o], xv[o + t], w[t]);
}

// KH > 0: the kernel height is KH and the weights sit in registers; KH == 0:
// any odd height p.kh, the weights read from shared memory per tap row. A
// thread computes R neighbouring output rows (R = 2 only with KH > 0): each
// input row it loads serves every output row it is a tap row of.
template <typename T, int KW, int KH, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw_conv_tile_kernel(const __grid_constant__ CUtensorMap tm, const Params p) {
  extern __shared__ uint8_t smem_raw[];  // aligned to 128 below
  __shared__ __align__(8) uint64_t full[kStages];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  float* wsm = reinterpret_cast<float*>(sm + kStages * p.stage_bytes);  // [kh][KW][CT], KH == 0

  const int kh = KH > 0 ? KH : p.kh;
  const int ct = (int)blockIdx.x / p.P;  // channel tile, and this block's first item
  const int first = (int)blockIdx.x - ct * p.P;
  const int c0 = ct * p.CT;
  const int NC = p.CT / kVec, NS = p.TW / kStrip;
  const int cv = (int)threadIdx.x % NC, q = (int)threadIdx.x / NC;  // once per block
  const int r = q / NS * R, s = q - (q / NS) * NS;  // first output row, strip in the tile
  const int WB = p.TW + KW - 1;
  const float inv_wb = 1.f / (float)WB;
  const int n_items = p.B * p.n_rt * p.n_wt;

  // item = (b * n_rt + rt) * n_wt + wt; this block's items are first,
  // first + P, ...: the digits of the item and of the step P, once
  int wt = first % p.n_wt, rt = (first / p.n_wt) % p.n_rt, b = first / p.n_wt / p.n_rt;
  const int dwt = p.P % p.n_wt, drt = (p.P / p.n_wt) % p.n_rt, db = p.P / p.n_wt / p.n_rt;
  // advance (w, r, b) digits by the step P, with carries
  auto step = [&](int& w, int& rr, int& bb) {
    w += dwt;
    rr += drt;
    bb += db;
    if (w >= p.n_wt) { w -= p.n_wt; ++rr; }
    if (rr >= p.n_rt) { rr -= p.n_rt; ++bb; }
  };
  auto stage = [&](int k) { return reinterpret_cast<T*>(sm + (k & 1) * p.stage_bytes); };

  if (p.route == kRouteTma) {
    if (threadIdx.x == 0) {
      mbar_init(&full[0], 1);
      mbar_init(&full[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // the first item's copy goes out before the weights are read, so the two
  // latencies overlap
  if (first < n_items)
    stage_load<T>(p, &tm, stage(0), &full[0], b, rt * p.TH, wt * p.TW, c0, kh, KW, inv_wb);
  // the weights of a tap for 4 channels, as f32 (zero past C)
  const T* wg = (const T*)p.wt;
  auto weight = [&](int tap, int v) {
    float w4[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int c = c0 + v * kVec + u;
      w4[u] = c < p.C ? to_f32(wg[(size_t)tap * p.C + c]) : 0.f;
    }
    return make_float4(w4[0], w4[1], w4[2], w4[3]);
  };
  float4 wr[KH > 0 ? KH : 1][KW];  // this thread's channels, every tap
  if constexpr (KH > 0) {
#pragma unroll
    for (int a = 0; a < KH; ++a)
#pragma unroll
      for (int t = 0; t < KW; ++t) wr[a][t] = weight(a * KW + t, cv);
  } else {
    // a thread per (tap, channel vector), all taps' loads in flight together
    for (int i = threadIdx.x; i < kh * KW * NC; i += blockDim.x) {
      const int tap = i / NC, v = i - (i / NC) * NC;  // once per block
      *reinterpret_cast<float4*>(wsm + tap * p.CT + v * kVec) = weight(tap, v);
    }
    __syncthreads();
  }

  int nw = wt, nr = rt, nb = b;  // the next item's digits
  step(nw, nr, nb);
  for (int k = 0, it = first; it < n_items; ++k, it += p.P) {
    if (it + p.P < n_items)
      stage_load<T>(p, &tm, stage(k + 1), &full[(k + 1) & 1], nb, nr * p.TH, nw * p.TW, c0,
                    kh, KW, inv_wb);
    else if (p.route == kRouteAsync)
      asm volatile("cp.async.commit_group;" ::: "memory");  // keeps one group per item
    if (p.route == kRouteTma)
      mbar_wait(&full[k & 1], (uint32_t)(k >> 1) & 1);
    else if (p.route == kRouteAsync)
      asm volatile("cp.async.wait_group 1;" ::: "memory");  // all but the next item's
    __syncthreads();

    const T* tile = stage(k) + (r * WB + s * kStrip) * p.CT + cv * kVec;
    float4 acc[R][kStrip];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int o = 0; o < kStrip; ++o) acc[i][o] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (KH > 0) {
      // input row j of the thread's window is tap row j - i of output row i
#pragma unroll
      for (int j = 0; j < KH + R - 1; ++j) {
        float4 xv[kStrip + KW - 1];
        load_row<T, KW>(xv, tile + j * WB * p.CT, p.CT);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int a = j - i;  // known at compile time; the clamp only keeps the index valid
          if (a >= 0 && a < KH) row_taps<KW>(acc[i], xv, wr[a < 0 ? 0 : a >= KH ? KH - 1 : a]);
        }
      }
    } else {
      for (int a = 0; a < kh; ++a) {
        float4 w[KW], xv[kStrip + KW - 1];
#pragma unroll
        for (int t = 0; t < KW; ++t)
          w[t] = *reinterpret_cast<const float4*>(wsm + (a * KW + t) * p.CT + cv * kVec);
        load_row<T, KW>(xv, tile + a * WB * p.CT, p.CT);
        row_taps<KW>(acc[0], xv, w);
      }
    }
    const int c = c0 + cv * kVec;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int h = rt * p.TH + r + i;
      if (h < p.H && c < p.C) {
        const int n = min(kVec, p.C - c);
        T* orow = (T*)p.out + ((size_t)b * p.H + h) * p.W * p.C + c;
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          const int col = wt * p.TW + s * kStrip + o;
          if (col < p.W) store_out(orow + (size_t)col * p.C, acc[i][o], n, p.store_vec);
        }
      }
    }
    __syncthreads();  // every read of this stage is done before it is refilled
    wt = nw;
    rt = nr;
    b = nb;
    step(nw, nr, nb);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library needs no link against libcuda
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// x as a 4-D (C, W, H, B) tensor in boxes of (CT, TW + kw - 1, TH + kh - 1,
// 1), no swizzle; elements outside the tensor read as zeros
cudaError_t tensor_map(CUtensorMap* map, const Params& p, int is_bf16) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elt = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H,
                              (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {p.C * elt, (cuuint64_t)p.W * p.C * elt,
                                 (cuuint64_t)p.H * p.W * p.C * elt};  // bytes
  const cuuint32_t box[4] = {(cuuint32_t)p.CT, (cuuint32_t)(p.TW + p.kw - 1),
                             (cuuint32_t)(p.TH + p.kh - 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(p.x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks of `kernel` one SM holds at (threads, smem) and the device's SM
// count, asked once per (device, kernel, threads, smem): the two queries and
// the shared-memory attribute would cost host time on every launch. The
// attribute only ever rises, so a launch with less shared memory stays
// valid. A thread-safe table, as the wrappers may be called from several
// threads.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int device, int threads, size_t smem, int* per_sm,
                          int* sms) {
  struct Entry {
    int device, threads;
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
    if (e.device == device && e.fn == fn && e.threads == threads && e.smem == smem) {
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
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  table.push_back({device, threads, fn, smem, *per_sm, *sms});
  return cudaSuccess;
}

template <typename T, int KW, int KH, int R>
cudaError_t launch(const CUtensorMap& tm, Params p, int n_ct, int threads, size_t smem,
                   int device, cudaStream_t s) {
  auto kernel = dw_conv_tile_kernel<T, KW, KH, R>;
  // enough blocks to fill every SM, split evenly over the channel tiles, and
  // no more blocks than a channel tile has items
  const long long items = (long long)p.B * p.n_rt * p.n_wt;
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocks_per_sm(kernel, device, threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long want = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long P = (want + n_ct - 1) / n_ct;
  P = P < items ? P : items;
  if (P * n_ct > 0x7fffffffLL || items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.P = (int)P;
  kernel<<<(unsigned)(P * n_ct), threads, smem, s>>>(tm, p);
  return cudaGetLastError();
}

template <typename T, int KW>
cudaError_t launch_kh(const CUtensorMap& tm, const Params& p, int n_ct, int threads,
                      size_t smem, int device, cudaStream_t s) {
  // weights in registers for 3 rows (2 output rows a thread, or 1); from
  // shared memory, one output row a thread, for any other height. Two rows
  // a thread are built for widths 1 and 3 only: wider ones spill.
  if (p.kh == 3 && p.R == 2) {
    if constexpr (KW <= 3) return launch<T, KW, 3, 2>(tm, p, n_ct, threads, smem, device, s);
    return cudaErrorInvalidValue;
  }
  if (p.R != 1) return cudaErrorInvalidValue;
  if (p.kh == 3) return launch<T, KW, 3, 1>(tm, p, n_ct, threads, smem, device, s);
  return launch<T, KW, 0, 1>(tm, p, n_ct, threads, smem, device, s);
}

template <typename T>
cudaError_t launch_t(const CUtensorMap& tm, const Params& p, int n_ct, int threads, size_t smem,
                     int device, cudaStream_t s) {
  switch (p.kw) {
    case 1: return launch_kh<T, 1>(tm, p, n_ct, threads, smem, device, s);
    case 3: return launch_kh<T, 3>(tm, p, n_ct, threads, smem, device, s);
    case 5: return launch_kh<T, 5>(tm, p, n_ct, threads, smem, device, s);
    case 7: return launch_kh<T, 7>(tm, p, n_ct, threads, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one block of a plan needs: two input
// boxes, each rounded up to 128 bytes, the f32 weights and 128 bytes of
// alignment slack (kernels/depthwise_conv.smem_bytes is the same sum).
long long smem_bytes(int CT, int TH, int TW, int kh, int kw, int is_bf16) {
  const long long box = (long long)(TH + kh - 1) * (TW + kw - 1) * CT * (is_bf16 ? 2 : 4);
  return kStages * ((box + 127) / 128 * 128) + (long long)kh * kw * CT * 4 + 128;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry or plan the kernel does not take (or
// a tensor map that cannot be encoded). The plan (CT, TH, TW, the output
// rows a thread R, the copy route, the copy and store widths) comes from
// the caller (kernels/depthwise_conv.depthwise_plan).
int depthwise_conv(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                   int KH, int KW, int is_bf16, int CT, int TH, int TW, int R, int route,
                   int copy_bytes, int store_vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int elt = is_bf16 ? 2 : 4;
  const long long smem = smem_bytes(CT, TH, TW, KH, KW, is_bf16);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || KH <= 0 || KH % 2 == 0 || CT <= 0 ||
      CT % kVec || (CT * elt) % 16 || TH <= 0 || TW <= 0 || TW % kStrip ||
      (R != 1 && R != 2) || TH % R || (CT / kVec) * (TH / R) * (TW / kStrip) > kMaxThreads ||
      smem > kMaxDynSmem ||
      (store_vec != 1 && store_vec != 2 && store_vec != 4) || C % store_vec)
    return (int)cudaErrorInvalidValue;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if (route == kRouteTma) {
    if ((C * elt) % 16 || base % 16 || TH + KH - 1 > 256 || TW + KW - 1 > 256 || CT > 256)
      return (int)cudaErrorInvalidValue;
  } else if (route == kRouteAsync) {
    if ((copy_bytes != 4 && copy_bytes != 8 && copy_bytes != 16) || (C * elt) % copy_bytes ||
        base % copy_bytes)
      return (int)cudaErrorInvalidValue;
  } else if (route != kRoutePlain) {
    return (int)cudaErrorInvalidValue;
  }
  const int box = (TH + KH - 1) * (TW + KW - 1) * CT * elt;
  const Params p{x, wt, out, B, H, W, C, KH, KW, CT, TH, TW, R,
                 (H + TH - 1) / TH, (W + TW - 1) / TW, /*P, set at launch*/ 1, route,
                 copy_bytes, store_vec, (uint32_t)((box + 127) / 128 * 128)};
  CUtensorMap tm = {};
  if (route == kRouteTma && (err = tensor_map(&tm, p, is_bf16)) != cudaSuccess) return (int)err;
  const int n_ct = (C + CT - 1) / CT;
  const int threads = (CT / kVec) * (TH / R) * (TW / kStrip);
  cudaStream_t s = (cudaStream_t)stream;
  err = is_bf16 ? launch_t<__nv_bfloat16>(tm, p, n_ct, threads, (size_t)smem, device, s)
                : launch_t<float>(tm, p, n_ct, threads, (size_t)smem, device, s);
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
