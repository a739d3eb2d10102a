// SirenWithSnakeTanh stack forward for Hopper (sm_90a), CUDA C++.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   inraudio_tpu/ops/pallas_siren.py:_stack_kernel_multi  (k windows, one grid)
//   inraudio_tpu/ops/pallas_siren.py:_stack_kernel        (one model, row tiles;
//                                                          without the RFF layer 0)
// Both compute the same thing: k windows x row tiles of one SirenWithSnakeTanh
// forward over a shared (n, d <= 8) coordinate grid. Here that is one kernel:
// the single-model call is k = 1.
//
// What bounds it on an H100 (by reading, not yet by measurement): one sample
// costs about 131 kFLOP at h = 128 (4 hidden h x h layers), and the default
// bf16x3 tier triples the multiply-adds, all run as fp32 FMAs on CUDA cores
// (67 TFLOP/s fp32 peak). So the kernel is fp32-FMA bound. Streaming each
// window's weights (266.8 KB at h = 128) from L2 for every row tile is
// secondary: a 64-row tile spends ~12x more cycles on FMAs than on its weight
// loads.
//
// Design, in answer to that:
// - one CTA per (window, row tile) of TM = 8192 / H rows (64 at h = 128),
//   256 threads, each holding a 4-row x 8-column register tile, so every
//   shared-memory load feeds 8-24 FMAs;
// - the activation tile stays in shared memory for the whole stack; the
//   current layer's W (64 KB at h = 128, too big for the static 48 KB, hence
//   the dynamic-smem attribute) is streamed in layer by layer, because one
//   window's full parameter set exceeds the 227 KB a block may use;
// - operands are split ONCE into bf16 hi/lo planes (stored as f32) as they
//   are written to shared memory, not per use;
// - the head (out = 1) is a reduction over h across a few lanes.
// Tensor cores (wgmma with bf16 hi/lo passes) are later work.
//
// Numerics (the comparison tests hold it to these):
// - layer 0: pre = b; pre = pre + x[:, d] * w[d] in f32, never a rounded pass;
// - matmul tiers per layer: highest = true f32; bf16 = one pass of
//   bf16-rounded operands; bf16x2 = xh*wh + xh*wl; bf16x3 = xh*wh +
//   (xh*wl + xl*wh), with hi = bf16_rn(v), lo = bf16_rn(v - hi). A product of
//   two bf16 values is exact in f32, so fmaf there equals mul + add;
// - sin/cos: exact sinf/cosf, or Cody-Waite reduction with k = rintf(...)
//   (round half to even, as jnp.round) and the odd polynomials of degree
//   7/9/11 with the JAX package's coefficients.
// Built WITHOUT --use_fast_math and with -fmad=false, so every elementwise
// expression rounds op by op as the JAX reference does; the dot products use
// explicit fmaf (their summation order differs from any matmul library's
// anyway, and is what the comparison tolerances cover). -fmad=false thus
// costs no tolerance: on an H100 at h = 128 the kernel matches its plain
// PyTorch version to 1.5e-8 in the bf16 tiers and 2.2e-7 in the f32 tiers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxIn = 8;
constexpr int kThreads = 256;

// layer kinds (must match inraudio_tpu_torch/ops/siren_fused.py)
constexpr int kLinear = 0;
constexpr int kSine = 1;
constexpr int kSnake = 2;
constexpr int kTanh = 3;

// matmul precision modes (must match siren_fused.py)
constexpr int kHighest = 0;
constexpr int kBf16 = 1;
constexpr int kBf16x2 = 2;
constexpr int kBf16x3 = 3;

struct LayerArgs {
  const float* w[kMaxLayers];  // (k, in, out) row-major, JAX layout
  const float* b[kMaxLayers];  // (k, out)
  const float* a[kMaxLayers];  // (k, out) snake frequency, or null
  int kind[kMaxLayers];
  int mode[kMaxLayers];        // matmul tier (unused for layer 0)
  int deg[kMaxLayers];         // 0 = exact sinf/cosf, else polynomial degree
  float omega[kMaxLayers];
  int n_layers;
  int in_features;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sin_poly(float r, int deg) {
  const float r2 = r * r;
  float p;
  if (deg == 7) {
    p = -0.0001477404380785241f;
    p = p * r2 + 0.007998575320167381f;
    p = p * r2 + -0.1658384294768091f;
    p = p * r2 + 0.999450173058242f;
  } else if (deg == 9) {
    p = 2.1732569600486186e-06f;
    p = p * r2 + -0.00019316269888602924f;
    p = p * r2 + 0.008312388279692877f;
    p = p * r2 + -0.16663259376823747f;
    p = p * r2 + 0.9999845934510802f;
  } else {
    p = -2.0534080047784251e-08f;
    p = p * r2 + 2.7040473313016951e-06f;
    p = p * r2 + -0.00019812572237557381f;
    p = p * r2 + 0.0083325579983740631f;
    p = p * r2 + -0.16666577198087604f;
    p = p * r2 + 0.99999970695822715f;
  }
  return r * p;
}

constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kTwoPiHi = 6.28125f;
constexpr float kTwoPiLo = 1.9353071795864769e-03f;
constexpr float kHalfPi = 1.5707963267948966f;

__device__ __forceinline__ float trig_sin(float x, int deg) {
  if (deg == 0) return sinf(x);
  const float k = rintf(x * kInvTwoPi);
  const float r = (x - k * kTwoPiHi) - k * kTwoPiLo;
  return sin_poly(r, deg);
}

__device__ __forceinline__ float trig_cos(float x, int deg) {
  if (deg == 0) return cosf(x);
  const float k = rintf(x * kInvTwoPi + 0.25f);
  const float r = ((x - k * kTwoPiHi) - k * kTwoPiLo) + kHalfPi;
  return sin_poly(r, deg);
}

__device__ __forceinline__ float activate(int kind, float pre, float omega,
                                          float a, int deg) {
  if (kind == kSine) return trig_sin(omega * pre, deg);
  if (kind == kSnake) {
    const float c = trig_cos((2.0f * a) * pre, deg);
    return pre + (0.5f / a) * (1.0f - c);
  }
  if (kind == kTanh) return tanhf(pre);
  return pre;
}

// Write v into the hi (and lo) planes in the form the consuming layer's
// matmul tier reads: exact for highest, bf16 splits otherwise.
__device__ __forceinline__ void split_store(float v, int mode, float* hi,
                                            float* lo, int idx) {
  if (mode == kHighest) {
    hi[idx] = v;
    return;
  }
  const float h = bf16r(v);
  hi[idx] = h;
  lo[idx] = bf16r(v - h);
}

__device__ __forceinline__ float4 split4_hi(float4 v, int mode) {
  if (mode == kHighest) return v;
  return make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Copy `count` floats (count % 4 == 0, 16-byte aligned source) of one
// window's matrix into shared memory as split planes.
__device__ __forceinline__ void load_split(const float* __restrict__ src,
                                           float* hi, float* lo, int count,
                                           int mode) {
  for (int e = threadIdx.x * 4; e < count; e += kThreads * 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + e));
    const float4 h = split4_hi(v, mode);
    *reinterpret_cast<float4*>(hi + e) = h;
    if (mode != kHighest)
      *reinterpret_cast<float4*>(lo + e) = split4_hi(sub4(v, h), kBf16);
  }
}

// acc[i][c] (+ acc2) += X[r0 + i, :] . W[:, col(c)] over the tile, in the
// given tier. Columns: c0 + 0..3 and c1 + 0..3.
template <int H, int MODE>
__device__ __forceinline__ void dense_tile(const float* Xhi, const float* Xlo,
                                           const float* Whi, const float* Wlo,
                                           int r0, int c0, int c1,
                                           float (&acc)[4][8],
                                           float (&acc2)[4][8]) {
  constexpr int LD = H + 4;
#pragma unroll 1
  for (int j = 0; j < H; j += 4) {
    float4 xh[4], xl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xh[i] = *reinterpret_cast<const float4*>(Xhi + (r0 + i) * LD + j);
      if (MODE == kBf16x3)
        xl[i] = *reinterpret_cast<const float4*>(Xlo + (r0 + i) * LD + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* wr = Whi + (j + jj) * H;
      const float4 a0 = *reinterpret_cast<const float4*>(wr + c0);
      const float4 a1 = *reinterpret_cast<const float4*>(wr + c1);
      const float wh[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float wl[8];
      if (MODE == kBf16x2 || MODE == kBf16x3) {
        const float* wlr = Wlo + (j + jj) * H;
        const float4 b0 = *reinterpret_cast<const float4*>(wlr + c0);
        const float4 b1 = *reinterpret_cast<const float4*>(wlr + c1);
        wl[0] = b0.x; wl[1] = b0.y; wl[2] = b0.z; wl[3] = b0.w;
        wl[4] = b1.x; wl[5] = b1.y; wl[6] = b1.z; wl[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = lane(xh[i], jj);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[i][c] = fmaf(xv, wh[c], acc[i][c]);
          if (MODE == kBf16x2 || MODE == kBf16x3)
            acc2[i][c] = fmaf(xv, wl[c], acc2[i][c]);
        }
        if (MODE == kBf16x3) {
          const float xlv = lane(xl[i], jj);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc2[i][c] = fmaf(xlv, wh[c], acc2[i][c]);
        }
      }
    }
  }
}

template <int H>
__host__ __device__ constexpr int tile_rows() { return 8192 / H; }

template <int H>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * H * H                        // W hi/lo
         + 2 * tile_rows<H>() * (H + 4)   // activation hi/lo
         + 2 * H                          // bias, snake a
         + tile_rows<H>() * kMaxIn;       // coordinates
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_stack_kernel(const float* __restrict__ coords, float* __restrict__ out,
                   const LayerArgs args, int n, int tiles) {
  constexpr int TM = tile_rows<H>();
  constexpr int LD = H + 4;
  constexpr int CG = H / 8;           // column groups of 2 x 4 columns
  constexpr int TPR = kThreads / TM;  // head: threads per row
  extern __shared__ float4 smem4[];
  float* Whi = reinterpret_cast<float*>(smem4);
  float* Wlo = Whi + H * H;
  float* Xhi = Wlo + H * H;
  float* Xlo = Xhi + TM * LD;
  float* sb = Xlo + TM * LD;
  float* sa = sb + H;
  float* sc = sa + H;

  const int tid = threadIdx.x;
  const long long win = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * TM;
  const int d = args.in_features;
  const int L = args.n_layers;

  // ---- layer 0: exact f32 multiply-adds over the d raw coordinates ----
  {
    const float* w0 = args.w[0] + win * d * H;
    for (int e = tid; e < d * H; e += kThreads) Whi[e] = w0[e];
    for (int e = tid; e < H; e += kThreads) {
      sb[e] = args.b[0][win * H + e];
      sa[e] = args.a[0] ? args.a[0][win * H + e] : 1.0f;
    }
    for (int e = tid; e < TM * d; e += kThreads) {
      const int row = row0 + e / d;
      sc[e] = row < n ? coords[(long long)row * d + e % d] : 0.0f;
    }
    __syncthreads();
    const int kind = args.kind[0], deg = args.deg[0], next = args.mode[1];
    const float omega = args.omega[0];
    for (int e = tid; e < TM * H; e += kThreads) {
      const int r = e / H, c = e % H;
      float pre = sb[c];
      for (int q = 0; q < d; ++q) pre = pre + sc[r * d + q] * Whi[q * H + c];
      split_store(activate(kind, pre, omega, sa[c], deg), next, Xhi, Xlo,
                  r * LD + c);
    }
  }

  // ---- hidden h x h layers ----
  const int cg = tid % CG;
  const int r0 = (tid / CG) * 4;
  const int c0 = cg * 4, c1 = H / 2 + cg * 4;
  for (int li = 1; li < L - 1; ++li) {
    const int mode = args.mode[li];
    __syncthreads();  // previous layer done with W, sb, sa and X writes
    load_split(args.w[li] + win * H * H, Whi, Wlo, H * H, mode);
    for (int e = tid; e < H; e += kThreads) {
      sb[e] = args.b[li][win * H + e];
      sa[e] = args.a[li] ? args.a[li][win * H + e] : 1.0f;
    }
    __syncthreads();
    float acc[4][8], acc2[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
    if (mode == kBf16x3)
      dense_tile<H, kBf16x3>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2);
    else if (mode == kBf16x2)
      dense_tile<H, kBf16x2>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2);
    else if (mode == kBf16)
      dense_tile<H, kBf16>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2);
    else
      dense_tile<H, kHighest>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2);
    __syncthreads();  // every thread has read X before it is overwritten
    const int kind = args.kind[li], deg = args.deg[li], next = args.mode[li + 1];
    const float omega = args.omega[li];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cb = half ? c1 : c0;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = half * 4 + q;
          const float pre = (acc[i][c] + acc2[i][c]) + sb[cb + q];
          v[q] = activate(kind, pre, omega, sa[cb + q], deg);
        }
        const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
        const float4 h4 = split4_hi(v4, next);
        const int idx = (r0 + i) * LD + cb;
        *reinterpret_cast<float4*>(Xhi + idx) = h4;
        if (next != kHighest)
          *reinterpret_cast<float4*>(Xlo + idx) = split4_hi(sub4(v4, h4), kBf16);
      }
    }
  }

  // ---- head: h -> 1, a reduction over h ----
  {
    const int li = L - 1;
    const int mode = args.mode[li];
    __syncthreads();
    load_split(args.w[li] + win * H, Whi, Wlo, H, mode);
    __syncthreads();
    const int r = tid / TPR, s = tid % TPR;
    const float* xh = Xhi + r * LD;
    const float* xl = Xlo + r * LD;
    float acc = 0.0f, acc2 = 0.0f;
    for (int j = s; j < H; j += TPR) {
      acc = fmaf(xh[j], Whi[j], acc);
      if (mode == kBf16x2 || mode == kBf16x3) acc2 = fmaf(xh[j], Wlo[j], acc2);
      if (mode == kBf16x3) acc2 = fmaf(xl[j], Whi[j], acc2);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
      acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
    }
    const int row = row0 + r;
    if (s == 0 && row < n) {
      const float pre = (acc + acc2) + args.b[li][win];
      const float a = args.a[li] ? args.a[li][win] : 1.0f;
      out[win * n + row] =
          activate(args.kind[li], pre, args.omega[li], a, args.deg[li]);
    }
  }
}

template <int H>
int launch(const LayerArgs& args, const float* coords, float* out, int k,
           int n, cudaStream_t stream) {
  const size_t smem = smem_floats<H>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      siren_stack_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + tile_rows<H>() - 1) / tile_rows<H>();
  const long long blocks = static_cast<long long>(tiles) * k;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  siren_stack_kernel<H><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(coords, out, args, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// coords: device (n, d) f32; out: device (k, n) f32.
// ptrs: host uint64[3 * n_layers] = w, b, a device pointers per layer (a = 0
// where the layer has no snake frequency). ints: host int32[3 * n_layers] =
// kind, mode, deg per layer. omegas: host float[n_layers].
// Returns a cudaError_t value: 0 when the launch was accepted.
int siren_stack_forward(const void* coords, void* out, const void* ptrs,
                        const void* ints, const void* omegas, int n_layers,
                        int k, int n, int d, int h, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn || k < 1 ||
      n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LayerArgs args;
  const uint64_t* p = static_cast<const uint64_t*>(ptrs);
  const int* q = static_cast<const int*>(ints);
  const float* om = static_cast<const float*>(omegas);
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool live = l < n_layers;
    args.w[l] = live ? reinterpret_cast<const float*>(p[3 * l]) : nullptr;
    args.b[l] = live ? reinterpret_cast<const float*>(p[3 * l + 1]) : nullptr;
    args.a[l] = live ? reinterpret_cast<const float*>(p[3 * l + 2]) : nullptr;
    args.kind[l] = live ? q[3 * l] : kLinear;
    args.mode[l] = live ? q[3 * l + 1] : kHighest;
    args.deg[l] = live ? q[3 * l + 2] : 0;
    args.omega[l] = live ? om[l] : 0.0f;
  }
  args.n_layers = n_layers;
  args.in_features = d;
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32: return launch<32>(args, c, o, k, n, s);
    case 64: return launch<64>(args, c, o, k, n, s);
    case 128: return launch<128>(args, c, o, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
