// Flash-attention forward for Hopper (sm_90a): o and lse = m + log(l).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fwd_kernel
// (called through _fwd_call): causal or full multi-head attention over
// (B, H, S, hd) with an online softmax across KV tiles, q_offset shifting the
// causal diagonal, KV tiles above the diagonal skipped. Three numeric modes,
// chosen by the C entry from the dtype and `lowp` (the reference's `cdt`,
// flash_attention.py:131-149):
//
//  1. bf16 inputs with lowp: the A operand of s = Q K^T is bf16(q * scale),
//     the scale applied in f32 before the rounding as the reference does; K
//     and V are bf16; p goes into P V rounded to bf16 while l sums the
//     unrounded f32 p. The tensor-core kernel below, SPLIT = false.
//  2. bf16 inputs without lowp (cdt = f32): q.k of bf16 operands is exact in
//     the f32 accumulator and scale is applied to s in f32 (for hd 16 and 64
//     the same as (q * scale).k; for hd 32 and 128 it differs by f32
//     rounding). p stays f32: it is split in registers into hi = bf16(p) and
//     lo = bf16(p - hi), and P V is issued twice into one accumulator, which
//     leaves at most 2^-16 sum p|v| per output before the division by l
//     (csrc/flash_bwd.cu splits p and ds the same way). SPLIT = true.
//  3. f32 inputs, with or without lowp: the FFMA kernel (first part of this
//     file), kept as first written and measured. Under lowp it rounds
//     q * scale formed in f32, as the reference does; rounding an f32 q to
//     bf16 first would round twice, so f32 calls never take the tensor cores.
// m, l and the accumulator are f32 in every mode; o = acc / max(l, 1e-30) in
// q's dtype, lse = m + log(max(l, 1e-30)) in the reference's scaled units,
// masked scores -1e30 (the JAX kernels' NEG_INF).
//
// What bounds it on the H100: at the prefill shapes of the serve path
// (S ~ 200..512, hd 64) the work is ~4*hd FLOPs per (query, key) pair against
// 16 bytes per (row, hd) element moved. In f32 on the CUDA cores (67 TFLOP/s)
// that is bound by operations. On the bf16 tensor cores (989 TFLOP/s) it is
// bound by bytes: B1 H32 S512 hd64 causal moves 8.45 MB, 0.0025 ms at 3.35
// TB/s, against 0.0011 ms of products (0.0016 with the split P V).
//
// The FFMA design (mode 3): the FMAs are fed from shared memory, whose
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
// the query rows and the keys are masked in the kernel. Its grid puts B*H on
// grid.y, whose limit is 65535: the host launches larger B*H in chunks of
// 65535 heads with the base pointers advanced, so the kernel body is the
// same code for any B*H.
//
// The tensor-core design (modes 1 and 2), csrc/flash_bwd.cu's dq kernel with
// one product fewer: a block is one consumer warpgroup (128 threads, 64 query
// rows: the M of one wgmma) and one producer warp. The producer's lane 0
// loads Q once and K and V tiles through a ring of kStages stages with TMA,
// through 3-D tensor maps (hd, S, b*h) in 64 x 64 boxes with the 128-byte
// swizzle: rows past S and columns past hd read as zeros and never come from
// the next head; hd 16 and 32 run as 64 columns, hd 128 as two 64-column
// slabs. K and V of a stage complete separate mbarriers, so s = Q K^T starts
// before V has landed. Under lowp the consumers rewrite the resident Q tile
// in place as bf16(q * scale) once it lands (elementwise, so the swizzle does
// not matter), then fence the generic-proxy stores for the async proxy that
// wgmma reads through. Per 64-key tile: s = Q K^T as wgmma m64n64k16 with
// both operands in shared memory (K-major); the mask evaluated only on the
// diagonal tile and the ragged tail; the row max over the four lanes that
// share an accumulator row; p = 2^(s * c * log2 e - m * log2 e) with one FMA
// and one ex2 on the special-function unit (c = 1 under lowp, scale
// otherwise); the accumulator rescaled by the correction factor; p's bf16
// fragments (hi, and lo under SPLIT) fed back as the register A operand of
// O += P V, with V the MN-major shared-memory B operand. Each thread keeps
// l over its own columns and reduces it across the row once, at the end.
// The grid is 1-D over (query tile, b*h), the query tiles with the most KV
// tiles first, so B*H has no 65535 limit. Registers per thread: s 32, the
// accumulator 32 (hd <= 64) or 64 (hd 128), p's fragments 16 (32 under
// SPLIT); built for two blocks per SM.
//
// Layout: q (B,H,Sq,HD), k and v (B,H,Sk,HD), o (B,H,Sq,HD), all contiguous,
// in f32 or bf16 (16-byte aligned for the tensor maps), HD in {16, 32, 64,
// 128}; lse (B,H,Sq) f32. The kernels allocate nothing and launch on the
// caller's stream.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF, not -inf
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of (ty, tx)
constexpr int kPRow = kBK + 16;    // P row stride: a warp's two rows on opposite bank halves
constexpr int kMaxGridY = 65535;   // heads per launch: the limit of grid.y

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
  // grid.y holds at most 65535 heads: larger B*H runs in chunks of heads,
  // each launch with its base pointers advanced (the kernel body unchanged)
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridY) {
    const int n = BH - bh0 < kMaxGridY ? BH - bh0 : kMaxGridY;
    const size_t qo = (size_t)bh0 * Sq * HD, ko = (size_t)bh0 * Sk * HD;
    const dim3 grid((Sq + kBQ - 1) / kBQ, n);
    kernel<<<grid, kThreads, bytes, stream>>>(
        (const T*)q + qo, (const T*)k + ko, (const T*)v + ko, (T*)o + qo,
        lse + (size_t)bh0 * Sq, Sq, Sk, causal, q_offset, scale, lowp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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


// ===========================================================================
// Tensor-core kernel: bf16 inputs (lowp, SPLIT = false; or not, SPLIT = true)
// ===========================================================================
// The TMA, mbarrier and wgmma helpers are copies of csrc/flash_bwd.cu's: each
// library is built from its one source, whose hash names the build.

constexpr int kRows = 64;                    // query rows of a block: one wgmma M
constexpr int kStages = 2;                   // ring of K and V tiles
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr uint32_t kSlab = 64 * 128;         // bytes of [64 rows][64 bf16], 128-byte rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
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

// one box (64 columns, 64 rows, 1 head) of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles of 128-byte
// rows (start, leading and stride byte offsets in 16-byte units; layout 1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major (the reduced dim along the row): 8-row groups 1024 bytes apart;
// a 16-wide k step starts 32 bytes further along the row
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major (the reduced dim down the rows): 8-row groups 1024 bytes apart,
// 64-column slabs kSlab apart; a 16-deep k step starts 2048 bytes further
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, kSlab, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses to accumulators across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64, f32) = (acc ? d : 0) + A (smem, K-major) * B (smem, K-major), 128B-swizzled
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (m64n64, f32) += A (registers, bf16) * B (smem, MN-major, 128B-swizzled)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A (registers, bf16) * B (smem, MN-major, 128B-swizzled)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (a p that small changes no f32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand (m64k16 bf16) of chunk kk from an m64n64 f32
// accumulator x whose columns are the reduced dim: register r holds columns
// 16kk + 8(r / 2) + 2 tig + {0, 1} of row gid + 8 (r % 2), which are x's
// elements 8kk + 2r and 8kk + 2r + 1. hi is x rounded to bf16 (RNE); with
// SPLIT, lo is the residual x - hi rounded to bf16.
template <bool SPLIT>
__device__ __forceinline__ void a_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(x0, x1);
      if constexpr (SPLIT) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
        lo[kk][r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
      }
    }
}

// acc += frag(x) B over 64 rows of B, B's k-th 16 rows at b_addr + 2048 k
template <int HDP, bool SPLIT>
__device__ __forceinline__ void product_rs(float (&acc)[HDP / 2], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor_desc(b_addr + 2048 * kk);
    wgmma_rs<HDP>(acc, hi[kk], db);
    if constexpr (SPLIT) wgmma_rs<HDP>(acc, lo[kk], db);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the consumers rewrite a resident bf16 tile in place as bf16(x * scale),
// the product formed in f32; elementwise, so the swizzle does not matter.
// The fence makes these generic-proxy stores visible to the async proxy
// (wgmma's operand reads); the named barrier orders every consumer's stores
// before any warp's first wgmma.
template <uint32_t BYTES>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float scale) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (uint32_t i = threadIdx.x; i < BYTES / 16; i += kConsumers) {
    uint4 w = p[i];
    uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
      u[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    p[i] = w;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

constexpr size_t tc_smem_bytes(int hdp) {
  return 1024 + (1 + 2 * kStages) * (size_t)(hdp / 64) * kSlab + 8 * (1 + 3 * kStages);
}

// One block per (64 query rows, b*h) on a 1-D grid; streams K and V tiles.
// Rows of a causal call with q_offset < 0 that see no key at all get o = 0
// and lse = -1e30 (as the FFMA kernel does for a block with no live tile).
template <int HDP, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int BH, int Sq, int Sk, int hd, int causal, int q_offset,
             float scale) {
  constexpr int NS = HDP / 64;
  constexpr uint32_t kTile = NS * kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sK = sQ + kTile;            // [kStages] tiles
  uint8_t* sV = sK + kStages * kTile;  // [kStages] tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + kStages * kTile);  // bar[0]: Q
  uint64_t* full_k = bar + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // block b: head b % BH, query tile n_q - 1 - b / BH (the causal tiles
  // with the most KV tiles start first)
  const int n_q = (Sq + kRows - 1) / kRows;
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int row0 = (n_q - 1 - (int)(blockIdx.x / (unsigned)BH)) * kRows;
  int n_kv = (Sk + 63) / 64;
  if (causal) {
    const int last_key = min(row0 + kRows - 1, Sq - 1) + q_offset;
    n_kv = last_key < 0 ? 0 : min(n_kv, last_key / 64 + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp: lane 0 issues every load
    if (threadIdx.x == kConsumers && n_kv > 0) {
      mbar_arrive_expect_tx(&bar[0], kTile);
      for (int c = 0; c < NS; ++c) tma_load(sQ + c * kSlab, &tm_q, &bar[0], 64 * c, row0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&full_k[s], kTile);
        for (int c = 0; c < NS; ++c)
          tma_load(sK + s * kTile + c * kSlab, &tm_k, &full_k[s], 64 * c, 64 * j, bh);
        mbar_arrive_expect_tx(&full_v[s], kTile);
        for (int c = 0; c < NS; ++c)
          tma_load(sV + s * kTile + c * kSlab, &tm_v, &full_v[s], 64 * c, 64 * j, bh);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int ra = row0 + 16 * (threadIdx.x >> 5) + gid, rb = ra + 8;
  // s comes out of the products scaled under lowp (Q was rescaled), as the
  // unscaled q.k otherwise; sl2 takes it to log2 units
  const float s_mul = SPLIT ? scale : 1.f;
  const float sl2 = s_mul * kLog2e;

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  // rows ra and rb: running max (scaled units) and this thread's part of l
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  if (n_kv > 0) {
    mbar_wait(&bar[0], 0);
    if constexpr (!SPLIT) scale_tile<kTile>(sQ, scale);
  }
  const uint32_t q_addr = smem_u32(sQ);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t k_addr = smem_u32(sK + s * kTile), v_addr = smem_u32(sV + s * kTile);
    mbar_wait(&full_k[s], parity);
    __syncwarp();  // the wgmmas below are warp-aligned

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
      wgmma_ss_n64(sc, kmajor_desc(q_addr + off), kmajor_desc(k_addr + off), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int key0 = 64 * j;
    if (key0 + 64 > Sk || (causal && key0 + 63 > row0 + q_offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int row = (i & 2) ? rb : ra;
        if (key >= Sk || (causal && key > row + q_offset)) sc[i] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, sc[i]);
      else mx_a = fmaxf(mx_a, sc[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {  // the four lanes of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, x));
    }
    // a row with every key of this tile masked keeps its max (>= -1e30)
    const float mn_a = fmaxf(m_a, mx_a * s_mul), mn_b = fmaxf(m_b, mx_b * s_mul);
    const float corr_a = exp2_ftz((m_a - mn_a) * kLog2e);
    const float corr_b = exp2_ftz((m_b - mn_b) * kLog2e);
    m_a = mn_a;
    m_b = mn_b;
    const float ml_a = mn_a * kLog2e, ml_b = mn_b * kLog2e;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // masked: 2^-inf = 0
      if (i & 2) {
        sc[i] = exp2_ftz(fmaf(sc[i], sl2, -ml_b));
        sum_b += sc[i];
      } else {
        sc[i] = exp2_ftz(fmaf(sc[i], sl2, -ml_a));
        sum_a += sc[i];
      }
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i & 2) ? corr_b : corr_a;

    uint32_t hi[4][4], lo[4][4];
    a_fragments<SPLIT>(sc, hi, lo);
    mbar_wait(&full_v[s], parity);
    __syncwarp();
    wgmma_fence();
    product_rs<HDP, SPLIT>(acc, hi, lo, v_addr);  // O += P V
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, x);
    l_b += __shfl_xor_sync(kFull, l_b, x);
  }
  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / lc_a, inv_b = 1.f / lc_b;
  const size_t rows = (size_t)bh * Sq;
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int row = (i & 2) ? rb : ra;
    const int col = 8 * (i >> 2) + 2 * tig;
    if (row < Sq && col < hd) {
      const float inv = (i & 2) ? inv_b : inv_a;
      *reinterpret_cast<__nv_bfloat162*>(o + (rows + row) * hd + col) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
  }
  if (tig == 0) {
    if (ra < Sq) lse[rows + ra] = m_a + logf(lc_a);
    if (rb < Sq) lse[rows + rb] = m_b + logf(lc_b);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

// a (hd, S, b*h) bf16 tensor in boxes of 64 columns x 64 rows x 1 head, the
// 128-byte swizzle; elements past hd or S read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* base, int hd, int S, int BH) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};  // bytes
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HDP, bool SPLIT>
cudaError_t launch_tc(const CUtensorMap (&m)[3], void* o, float* lse, int BH, int Sq, int Sk,
                      int hd, int causal, int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes(HDP);
  auto kernel = flash_fwd_tc<HDP, SPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((Sq + kRows - 1) / kRows) * (unsigned)BH;
  kernel<<<blocks, kTcThreads, bytes, stream>>>(m[0], m[1], m[2], (__nv_bfloat16*)o, lse, BH,
                                                Sq, Sk, hd, causal, q_offset, scale);
  return cudaGetLastError();
}

// bf16 inputs: the tensor-core kernel, p split into bf16 pairs unless lowp.
// A tensor map that cannot be encoded fails the call; nothing falls back.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
                        bool split, cudaStream_t stream) {
  CUtensorMap m[3];
  cudaError_t err;
  if ((err = tensor_map(&m[0], q, hd, Sq, BH)) != cudaSuccess ||
      (err = tensor_map(&m[1], k, hd, Sk, BH)) != cudaSuccess ||
      (err = tensor_map(&m[2], v, hd, Sk, BH)) != cudaSuccess)
    return err;
  if (hd <= 64)
    return split ? launch_tc<64, true>(m, o, lse, BH, Sq, Sk, hd, causal, q_offset, scale, stream)
                 : launch_tc<64, false>(m, o, lse, BH, Sq, Sk, hd, causal, q_offset, scale, stream);
  return split ? launch_tc<128, true>(m, o, lse, BH, Sq, Sk, hd, causal, q_offset, scale, stream)
               : launch_tc<128, false>(m, o, lse, BH, Sq, Sk, hd, causal, q_offset, scale, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels were not built for (or a
// tensor map that cannot be encoded). bf16 inputs run the tensor-core
// kernel, f32 inputs the FFMA one.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Sq, int Sk, int hd, int causal, int q_offset,
              float scale, int is_bf16, int lowp, int device, void* stream) {
  if (Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    err = dispatch_tc(q, k, v, o, (float*)lse, B * H, Sq, Sk, hd, causal, q_offset, scale,
                      lowp == 0, s);
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
