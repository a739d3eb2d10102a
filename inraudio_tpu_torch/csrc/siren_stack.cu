// SirenWithSnakeTanh stack forward for Hopper (sm_90a), CUDA C++.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   inraudio_tpu/ops/pallas_siren.py:_stack_kernel_multi  (k windows, one grid)
//   inraudio_tpu/ops/pallas_siren.py:_stack_kernel        (one model, row tiles)
//   inraudio_tpu/ops/pallas_siren.py:_rff_features_in_kernel (the RFF layer 0
//                                                          of _stack_kernel)
// All compute the same thing: k windows x row tiles of one SirenWithSnakeTanh
// forward over a shared (n, d <= 8) coordinate grid. Here that is one kernel:
// the single-model call is k = 1, and an RFF model's layer 0 is a variant of
// layer 0 (n_freq > 0).
//
// What bounds it on an H100 (by reading): one sample costs about 131 kFLOP at
// h = 128 (4 hidden h x h layers; 525 kFLOP at h = 256, plus 262 kFLOP for an
// F = 256 RFF layer 0), and the default bf16x3 tier triples the
// multiply-adds, all run as fp32 FMAs on CUDA cores (67 TFLOP/s fp32 peak).
// So the kernel is fp32-FMA bound. Streaming each window's weights from L2
// for every row tile is secondary: a tile spends ~12x more cycles on FMAs
// than on its weight loads.
//
// Design, in answer to that:
// - one CTA per (window, row tile) of TM = 8192 / H rows (64 at h = 128, 32
//   at h = 256), 256 threads, each holding a 4-row x 8-column register tile,
//   so every shared-memory load feeds 8-24 FMAs;
// - the activation tile stays in shared memory for the whole stack; each
//   layer's W is streamed in, in K-slabs of slab_rows<H>() rows (the whole
//   W up to h = 128; 64 rows at h = 256, where one W's planes take 512 KB
//   against the 227 KB a block may use), the accumulators kept in registers
//   across the slabs;
// - operands are split ONCE into bf16 hi/lo planes (stored as f32) as they
//   are written to shared memory, not per use;
// - RFF layer 0: each K-slab of features (cos v, sin v of that slab's
//   frequencies, v = x . 2 pi B^T from the tile's coordinates) is computed
//   into the activation planes, split there, and multiplied by the matching
//   slab of W0: the (rows, 2F) feature matrix never reaches device memory;
// - the head (out = 1) is a reduction over h across a few lanes.
// Tensor cores (wgmma with bf16 hi/lo passes) are later work.
//
// Numerics (the comparison tests hold it to these):
// - raw layer 0: pre = b; pre = pre + x[:, d] * w[d] in f32, never a rounded
//   pass; RFF layer 0: v by exact f32 multiply-adds, then [cos v, sin v] @
//   W0 in the forward tier, cos / sin of layer 0's feature degree;
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
//
// The helpers it shares with the training kernels (siren_train.cu) are in
// siren_common.cuh.

#include "siren_common.cuh"

namespace {

struct LayerArgs {
  const float* w[kMaxLayers];  // (k, in, out) row-major, JAX layout
  const float* b[kMaxLayers];  // (k, out)
  const float* a[kMaxLayers];  // (k, out) snake frequency, or null
  int kind[kMaxLayers];
  int mode[kMaxLayers];        // matmul tier (RFF layer 0: its forward tier)
  int deg[kMaxLayers];         // 0 = exact sinf/cosf, else polynomial degree
  float omega[kMaxLayers];
  int n_layers;
  int in_features;             // raw coordinate columns d
  const float* bt;             // RFF: 2 pi B^T (d, F), or null
  int n_freq;                  // F (0: raw layer 0)
  int fdeg;                    // the RFF features' trig degree
  float* pre0;                 // optional (k, n, H) copy of layer 0's pre
};

template <int H>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * slab_rows<H>() * H           // W slab hi/lo
         + 2 * tile_rows<H>() * (H + 4)   // activation hi/lo
         + 2 * H                          // bias, snake a
         + tile_rows<H>() * kMaxIn;       // coordinates
}

static_assert(smem_floats<32>() * 4 <= 232448, "smem h=32");
static_assert(smem_floats<64>() * 4 <= 232448, "smem h=64");
static_assert(smem_floats<128>() * 4 <= 232448, "smem h=128");
static_assert(smem_floats<256>() * 4 <= 232448, "smem h=256");

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_stack_kernel(const float* __restrict__ coords, float* __restrict__ out,
                   const LayerArgs args, int n, int tiles) {
  constexpr int TM = tile_rows<H>();
  constexpr int LD = H + 4;
  constexpr int KS = slab_rows<H>();
  constexpr int CG = H / 8;           // column groups of 2 x 4 columns
  constexpr int TPR = kThreads / TM;  // head: threads per row
  extern __shared__ float4 smem4[];
  float* Whi = reinterpret_cast<float*>(smem4);
  float* Wlo = Whi + KS * H;
  float* Xhi = Wlo + KS * H;
  float* Xlo = Xhi + TM * LD;
  float* sb = Xlo + TM * LD;
  float* sa = sb + H;
  float* sc = sa + H;

  const int tid = threadIdx.x;
  const long long win = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * TM;
  const int d = args.in_features;
  const int L = args.n_layers;
  const int cg = tid % CG;
  const int r0 = (tid / CG) * 4;
  const int c0 = cg * 4, c1 = H / 2 + cg * 4;

  // ---- layer 0 ----
  {
    for (int e = tid; e < H; e += kThreads) {
      sb[e] = args.b[0][win * H + e];
      sa[e] = args.a[0] ? args.a[0][win * H + e] : 1.0f;
    }
    for (int e = tid; e < TM * d; e += kThreads) {
      const int row = row0 + e / d;
      sc[e] = row < n ? coords[(long long)row * d + e % d] : 0.0f;
    }
    const int kind = args.kind[0], deg = args.deg[0], next = args.mode[1];
    const float omega = args.omega[0];
    float* pre_out = args.pre0 ? args.pre0 + win * n * H : nullptr;
    if (args.n_freq > 0) {
      // RFF: [cos v, sin v] @ W0 in the forward tier, by K-slabs
      float acc[4][8], acc2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
      rff_layer0<H>(args.w[0] + win * 2 * args.n_freq * H, args.bt, sc, d,
                    args.n_freq, args.fdeg, args.mode[0], Whi, Wlo, Xhi, Xlo,
                    r0, c0, c1, acc, acc2);
      __syncthreads();  // every thread has read the features
      store_tile<H>(acc, acc2, sb, sa, kind, omega, deg, next, Xhi, Xlo, r0,
                    c0, c1, pre_out, row0, n);
    } else {
      // raw coordinates: exact f32 multiply-adds
      const float* w0 = args.w[0] + win * d * H;
      for (int e = tid; e < d * H; e += kThreads) Whi[e] = w0[e];
      __syncthreads();
      for (int e = tid; e < TM * H; e += kThreads) {
        const int r = e / H, c = e % H;
        float pre = sb[c];
        for (int q = 0; q < d; ++q) pre = pre + sc[r * d + q] * Whi[q * H + c];
        if (pre_out != nullptr && row0 + r < n)
          pre_out[(long long)(row0 + r) * H + c] = pre;
        split_store(activate(kind, pre, omega, sa[c], deg), next, Xhi, Xlo,
                    r * LD + c);
      }
    }
  }

  // ---- hidden h x h layers, W by K-slabs ----
  for (int li = 1; li < L - 1; ++li) {
    const int mode = args.mode[li];
    float acc[4][8], acc2[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
    for (int k0 = 0; k0 < H; k0 += KS) {
      __syncthreads();  // previous slab / layer done with W, sb, sa, X
      load_split(args.w[li] + win * H * H + k0 * H, Whi, Wlo, KS * H, mode);
      if (k0 == 0) {
        for (int e = tid; e < H; e += kThreads) {
          sb[e] = args.b[li][win * H + e];
          sa[e] = args.a[li] ? args.a[li][win * H + e] : 1.0f;
        }
      }
      __syncthreads();
      dense_dispatch<H>(mode, Xhi + k0, Xlo + k0, Whi, Wlo, r0, c0, c1, acc,
                        acc2, KS);
    }
    __syncthreads();  // every thread has read X before it is overwritten
    store_tile<H>(acc, acc2, sb, sa, args.kind[li], args.omega[li],
                  args.deg[li], args.mode[li + 1], Xhi, Xlo, r0, c0, c1,
                  nullptr, row0, n);
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
// bt: device (d, F) f32 = 2 pi B^T of an RFF model (n_freq = F > 0; layer
// 0's w is then (k, 2F, h), 16-byte aligned), or null with n_freq = 0;
// fdeg: the features' trig degree.  pre0: device (k, n, h) f32 receiving
// layer 0's pre-activation, or null.
// Returns a cudaError_t value: 0 when the launch was accepted.
int siren_stack_forward(const void* coords, void* out, const void* ptrs,
                        const void* ints, const void* omegas, int n_layers,
                        int k, int n, int d, int h, const void* bt, int n_freq,
                        int fdeg, void* pre0, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn || k < 1 ||
      n < 1 || n_freq < 0 || (n_freq > 0) != (bt != nullptr))
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
  args.bt = static_cast<const float*>(bt);
  args.n_freq = n_freq;
  args.fdeg = fdeg;
  args.pre0 = static_cast<float*>(pre0);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32: return launch<32>(args, c, o, k, n, s);
    case 64: return launch<64>(args, c, o, k, n, s);
    case 128: return launch<128>(args, c, o, k, n, s);
    case 256: return launch<256>(args, c, o, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
