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
// What the design does about it: threads run along C, so a warp's loads and
// stores of one pixel's channels are neighbouring addresses (coalesced for any
// C, including ShuffleNetV2's 58, 116 and 232: every access is a scalar of the
// element type, so no width has a vector edge to handle). Each thread owns a
// strip of kTW = 4 neighbouring output columns of one (b, h, c): per kernel
// row it loads the kTW + kw - 1 inputs of the strip once into registers and
// reuses them for all kw column taps, so an input element is fetched about
// kh * (kTW + kw - 1) / kTW times (4.5 for a 3x3), from L1 and L2 rather than
// device memory. The SAME boundary is masked in the kernel (rows outside the
// image are skipped, columns outside load zero), so no padded copy of x is
// made; the reference pads rows outside its kernel instead. kw is a template
// argument (1, 3, 5 or 7) so the strip and its taps unroll into registers; kh
// is a loop bound.
//
// Layout: x (B,H,W,C), wt (kh,kw,C), out (B,H,W,C), contiguous, f32 or bf16,
// kh odd, kw in {1,3,5,7}. The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 4;  // output columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int KW>
__global__ void __launch_bounds__(kThreads)
dw_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ out,
               int B, int H, int W, int C, int KH) {
  const int strips = (W + kTW - 1) / kTW;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = (long long)B * H * strips * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long rest = idx / C;
  const int w0 = (int)(rest % strips) * kTW;
  rest /= strips;
  const int h = (int)(rest % H);
  const int b = (int)(rest / H);
  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;

  float acc[kTW];
#pragma unroll
  for (int t = 0; t < kTW; ++t) acc[t] = 0.f;

  for (int a = 0; a < KH; ++a) {
    const int hi = h + a - ph;
    if (hi < 0 || hi >= H) continue;  // SAME: the row is zero padding
    const T* xrow = x + ((long long)b * H + hi) * W * C + c;
    float xv[kTW + KW - 1];
#pragma unroll
    for (int j = 0; j < kTW + KW - 1; ++j) {
      const int wi = w0 + j - pw;
      xv[j] = (wi >= 0 && wi < W) ? to_f32(xrow[(long long)wi * C]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      const float tap = to_f32(wt[(a * KW + t) * C + c]);
#pragma unroll
      for (int o = 0; o < kTW; ++o) acc[o] = fmaf(xv[o + t], tap, acc[o]);
    }
  }
  T* orow = out + (((long long)b * H + h) * W + w0) * C + c;
#pragma unroll
  for (int o = 0; o < kTW; ++o)
    if (w0 + o < W) store(orow + (long long)o * C, acc[o]);
}

template <typename T, int KW>
cudaError_t launch_kw(const void* x, const void* wt, void* out, int B, int H, int W,
                      int C, int KH, cudaStream_t s) {
  const long long total = (long long)B * H * ((W + kTW - 1) / kTW) * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dw_conv_kernel<T, KW><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)x, (const T*)wt, (T*)out, B, H, W, C, KH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* wt, void* out, int B, int H, int W,
                     int C, int KH, int KW, cudaStream_t s) {
  switch (KW) {
    case 1: return launch_kw<T, 1>(x, wt, out, B, H, W, C, KH, s);
    case 3: return launch_kw<T, 3>(x, wt, out, B, H, W, C, KH, s);
    case 5: return launch_kw<T, 5>(x, wt, out, B, H, W, C, KH, s);
    case 7: return launch_kw<T, 7>(x, wt, out, B, H, W, C, KH, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int depthwise_conv(const void* x, const void* wt, void* out, int B, int H, int W,
                   int C, int KH, int KW, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || KH <= 0 || KH % 2 == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    err = launch_t<__nv_bfloat16>(x, wt, out, B, H, W, C, KH, KW, s);
  } else {
    err = launch_t<float>(x, wt, out, B, H, W, C, KH, KW, s);
  }
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
