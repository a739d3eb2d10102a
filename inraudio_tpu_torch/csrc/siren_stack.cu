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
// What bounds it on an H100: one sample costs about 131 kFLOP at h = 128 (4
// hidden h x h layers; 525 kFLOP at h = 256, plus 262 kFLOP for an F = 256
// RFF layer 0), three times that in multiply-adds in the default bf16x3
// tier. On the bf16 tensor cores (989 TFLOP/s) the headline decode's
// products take 0.137 ms; as fp32 FMAs on CUDA cores (67 TFLOP/s) 2.0 ms.
// The elementwise epilogue (Cody-Waite sin, ~25 operations a unit) adds
// 0.1-0.2 ms on CUDA cores.
//
// Two routes, chosen per call by ops/siren_fused.py: stack_launch from the
// plan and the shapes:
// - the bf16, bf16x2 and bf16x3 plans run on the tensor cores
//   (siren_stack_tc_kernel, with siren_stack_split_kernel; below);
// - a plan with a `highest` layer (an exact f32 product, which no bf16
//   tensor-core pass gives) runs the FMA kernel, siren_stack_kernel:
//   - one CTA per (window, row tile) of TM = 8192 / H rows (64 at h = 128,
//     32 at h = 256), 256 threads, each holding a 4-row x 8-column register
//     tile, so every shared-memory load feeds 8-24 FMAs;
//   - the activation tile stays in shared memory for the whole stack; each
//     layer's W is streamed in, in K-slabs of slab_rows<H>() rows (the whole
//     W up to h = 128; 64 rows at h = 256, where one W's planes take 512 KB
//     against the 227 KB a block may use), the accumulators kept in
//     registers across the slabs;
//   - operands are split ONCE into bf16 hi/lo planes (stored as f32) as
//     they are written to shared memory, not per use;
//   - RFF layer 0: each K-slab of features (cos v, sin v of that slab's
//     frequencies, v = x . 2 pi B^T from the tile's coordinates) is
//     computed into the activation planes, split there, and multiplied by
//     the matching slab of W0: the (rows, 2F) feature matrix never reaches
//     device memory;
//   - the head (out = 1) is a reduction over h across a few lanes.
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
// PyTorch version to 1.5e-8 in the bf16 tiers and 2.2e-7 in the f32 tiers
// (the FMA kernel). The tensor-core route sums 16 products at a time in the
// tensor core; its tolerances are the same.
//
// The helpers it shares with the training kernels (siren_train.cu) are in
// siren_common.cuh and mma_common.cuh.

#include "mma_common.cuh"

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

// ===========================================================================
// The tensor-core route: every plan whose product layers (layers 1+, and an
// RFF layer 0) are all bf16, bf16x2 or bf16x3.  Two launches a call:
// - siren_stack_split_kernel: each window's h x h weights (and an RFF W0)
//   into packed bf16 hi/lo planes in device memory, once per call (lo only
//   where the layer's tier reads it), not once per row tile;
// - siren_stack_tc_kernel<H>: one CTA of 16 warps per (window, `rows`
//   rows).  The rows' activations live in shared memory as bf16 hi/lo
//   planes (pitch H + 8, so that ldmatrix and the epilogue's stores are
//   free of bank conflicts) from layer 0 to the head; they never reach
//   device memory.  Each hidden layer's W planes come in by cp.async: the
//   whole W at H <= 128, read by every pass of the CTA's rows (the next
//   layer's W is in flight during the last pass's epilogue); 64-row K-slabs
//   in two stages at H = 256, where one W's planes (270 KB) exceed the 227
//   KB a block may use.  A pass is 32 rows a warp row: each warp a 32 x 32
//   block, in bf16x3 on mma.sync m16n8k16 (tier_mma: hi.hi and the cross
//   terms in separate f32 accumulators, pre = (hh + cross) + b, as
//   store_tile and the plain version's _kernel_dot sum it); in bf16 and
//   bf16x2, whose x role is rounded, as the FMA kernel's fp32 FMA chains on
//   the same planes (hidden_product says why).  The warps that share a
//   pass's rows meet at a named barrier before the epilogue writes the
//   layer's output over its input, so the other row groups run on.
// - RFF layer 0: per K-slab of W0's 2F rows, the slab's features (cos v,
//   sin v from the rows' coordinates) are computed into the activation
//   planes and multiplied by the slab on mma.sync, each k16 step into fresh
//   accumulators added in f32 (tier_mma_f32, as the sweep's RFF layer 0):
//   its 2F-deep sum keeps the f32 rounding of an FMA chain, which the
//   layer-0 pre's few-ulp tolerance needs.
// - Kept from the FMA kernel, value for value: the raw layer 0 (exact f32
//   multiply-adds), the epilogue (activate(), the bf16 splits), and the
//   head's reduction over h in the FMA kernel's chains (H / 32 threads a
//   row; one output column would waste 7/8 of an n8 tile).
// What held it on an H100 (PR 9 timed the parts): with the
// layer's kind and trig degree read at run time inside the epilogue, its
// unrolled units were separate branchy chains that 8 warps could not hide
// (the activations took 1.3 of the headline's 2.4 ms); they are now
// template constants (with_activation), so activate() folds to straight
// code the compiler interleaves, and 16 warps a CTA (128 registers) hide
// the rest.
// The plan (rows a CTA, the route) is ops/siren_fused.py: stack_launch, a
// function of the plan and the shapes, never of k.
// ===========================================================================

// Warps a CTA and W rows a streamed slab at h = 256 (two stages of 64): on
// an H100 8 warps and four stages of 32 rows were each slower, and so were
// the bf16x3 hidden layers' products summed in fresh accumulators
// (tier_mma_f32) in place of the tensor core's (tier_mma) (PR 9, PERF.md;
// ops/siren_fused.py's _TC_PASS_ROWS, _TC_MAX_ROWS and stack_launch follow
// these).
constexpr int kTcWarps = 16;
constexpr int kTcSlab = 64;

template <int H>
struct Tc {
  static constexpr int WARPS = kTcWarps;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WN =  // warps along columns
      H / 32 < WARPS / 2 ? H / 32 : WARPS / 2;
  static constexpr int WM = WARPS / WN;        // warps along rows
  static constexpr int WC = H / WN;            // columns a warp
  static constexpr int NT = WC / 8;            // n8 tiles a warp
  static constexpr int TP = 32 * WM;           // rows a pass
  static constexpr bool kStream = H > 128;  // W by K-slabs
  static constexpr int KS = kStream ? kTcSlab : H;  // W rows a slab
  static constexpr int NST = kStream ? 128 / KS : 1;         // slab stages
  static constexpr int LD = H + 8;             // plane pitch (bf16)
  static constexpr int max_rows = kStream ? TP : (TP > 256 ? TP : 256);
  // activation planes, W slab stages, two buffers of (b, snake a), coords
  static constexpr size_t smem_bytes(int rows) {
    return static_cast<size_t>(2 * rows * LD) * 2 +
           static_cast<size_t>(NST * 2 * KS * LD) * 2 +
           static_cast<size_t>(4 * H + rows * kMaxIn) * 4;
  }
};

static_assert(Tc<32>::smem_bytes(Tc<32>::max_rows) <= 232448, "tc h=32");
static_assert(Tc<64>::smem_bytes(Tc<64>::max_rows) <= 232448, "tc h=64");
static_assert(Tc<128>::smem_bytes(Tc<128>::max_rows) <= 232448, "tc h=128");
static_assert(Tc<256>::smem_bytes(Tc<256>::max_rows) <= 232448, "tc h=256");
static_assert(Tc<256>::KS * 2 <= 256, "two feature slabs in the X planes");
static_assert(Tc<256>::NST >= 2, "streamed W needs two stages");

// Where each layer's planes are in the split kernel's output: layer li of
// window w has its hi plane (K[li] x h) at off[li] + w * 2 * K[li] * h and
// its lo plane right after.
struct PlaneArgs {
  const bf16* base;
  long long off[kMaxLayers];
  int K[kMaxLayers];
};

// Grid (windows x bpw blocks, layers from l0): each thread splits 4
// consecutive floats of one window's W.
__global__ void __launch_bounds__(kThreads)
siren_stack_split_kernel(const LayerArgs args, const PlaneArgs pa,
                         bf16* __restrict__ planes, int h, int l0, int bpw) {
  const int li = l0 + blockIdx.y;
  const int kh = pa.K[li] * h;
  const long long win = blockIdx.x / bpw;
  const int e = ((blockIdx.x % bpw) * kThreads + threadIdx.x) * 4;
  if (e >= kh) return;
  const float4 v =
      __ldg(reinterpret_cast<const float4*>(args.w[li] + win * kh + e));
  bf16* hi = planes + pa.off[li] + win * 2 * kh + e;
  const float x[4] = {v.x, v.y, v.z, v.w};
  bf16 hv[4], lv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_bf16(x[q], hv + q, lv + q);
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<const uint2*>(hv);
  if (args.mode[li] != kBf16)
    *reinterpret_cast<uint2*>(hi + kh) = *reinterpret_cast<const uint2*>(lv);
}

// Rows [k0, k0 + KS) of a (K x H) plane pair into a slab stage (pitch LD);
// rows at or past K are zero.  The lo plane only where the tier reads it.
template <int H>
__device__ __forceinline__ void issue_slab(bf16* dst, const bf16* wh, int K,
                                           int k0, bool lo) {
  using C = Tc<H>;
  constexpr int VEC = H / 8;  // 16-byte vectors a row
  const long long kh = static_cast<long long>(K) * H;
  for (int e = threadIdx.x; e < (lo ? 2 : 1) * C::KS * VEC;
       e += C::THREADS) {
    const int plane = e / (C::KS * VEC), q = e % (C::KS * VEC);
    const int r = q / VEC, v = q % VEC;
    const bool ok = k0 + r < K;
    cp_async16(dst + (plane * C::KS + r) * C::LD + v * 8,
               wh + plane * kh + static_cast<long long>(ok ? k0 + r : 0) * H +
                   v * 8,
               ok ? 16 : 0);
  }
}

// hh, cr += A[arow.., acol..] . B[0.., c0..] over ksteps k16 steps for the
// warp's 32 x WC block: A the activation planes (x role: hi, lo), B a slab
// stage (w role: hi, lo; K x H row-major, read with .trans). F32_STEPS:
// each k16 step into fresh accumulators added in f32 (tier_mma_f32, RFF
// layer 0), else summed in the tensor core (tier_mma, the hidden layers).
template <int H, int MODE, bool F32_STEPS>
__device__ __forceinline__ void tc_product(
    const bf16* Xh, const bf16* Xl, int arow, int acol, const bf16* Wh,
    const bf16* Wl, int ksteps, float (&hh)[2][Tc<H>::NT][4],
    float (&cr)[2][Tc<H>::NT][4]) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) % C::WN * C::WC;
#pragma unroll 1  // not unrolled: 128 registers hold it unspilled
  for (int s = 0; s < ksteps; ++s) {
    const int kk = s * 16;
    unsigned ah[2][4], al[2][4] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int off = (arow + mi * 16 + (lane & 15)) * C::LD + acol + kk +
                      (lane >> 4) * 8;
      ldsm_x4(ah[mi], Xh + off);
      if (MODE == kBf16x3) ldsm_x4(al[mi], Xl + off);
    }
    const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int nj = 0; nj < C::NT; nj += 2) {
      unsigned bh[4], bl[4] = {};
      const int off = brow * C::LD + c0 + nj * 8 + (lane >> 4) * 8;
      ldsm_x4_t(bh, Wh + off);
      if (MODE != kBf16) ldsm_x4_t(bl, Wl + off);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (F32_STEPS) {
          tier_mma_f32<MODE>(hh[mi][nj], cr[mi][nj], ah[mi], al[mi], bh[0],
                             bh[1], bl[0], bl[1]);
          tier_mma_f32<MODE>(hh[mi][nj + 1], cr[mi][nj + 1], ah[mi], al[mi],
                             bh[2], bh[3], bl[2], bl[3]);
        } else {
          tier_mma<MODE>(hh[mi][nj], cr[mi][nj], ah[mi], al[mi], bh[0],
                         bh[1], bl[0], bl[1]);
          tier_mma<MODE>(hh[mi][nj + 1], cr[mi][nj + 1], ah[mi], al[mi],
                         bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
  }
}

// hh, cr += the same block's product as fp32 FMAs in k order: the FMA
// kernel's chains (dense_tile: hi.hi into hh; hi.lo into cr in bf16x2), so
// the pres are that kernel's bit for bit.  Two k a step, x read as bf16
// pairs.
template <int H, int MODE>
__device__ __forceinline__ void seq_product(
    const bf16* Xh, int arow, int acol, const bf16* Wh, const bf16* Wl,
    int ksteps, float (&hh)[2][Tc<H>::NT][4], float (&cr)[2][Tc<H>::NT][4]) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31;
  const int r0 = arow + (lane >> 2);
  const int c0 = (threadIdx.x >> 5) % C::WN * C::WC + (lane & 3) * 2;
#pragma unroll 1
  for (int k = acol; k < acol + ksteps * 16; k += 2) {
    float x[2][2][2];  // [mi][half][k, k + 1]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bf162 v = *reinterpret_cast<const bf162*>(
            Xh + (r0 + mi * 16 + half * 8) * C::LD + k);
        x[mi][half][0] = __bfloat162float(v.x);
        x[mi][half][1] = __bfloat162float(v.y);
      }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int wrow = (k - acol + kk) * C::LD;
#pragma unroll
      for (int nj = 0; nj < C::NT; ++nj) {
        const bf162 h2 =
            *reinterpret_cast<const bf162*>(Wh + wrow + c0 + nj * 8);
        const float wh[2] = {__bfloat162float(h2.x), __bfloat162float(h2.y)};
        float wl[2] = {0.0f, 0.0f};
        if (MODE == kBf16x2) {
          const bf162 l2 =
              *reinterpret_cast<const bf162*>(Wl + wrow + c0 + nj * 8);
          wl[0] = __bfloat162float(l2.x);
          wl[1] = __bfloat162float(l2.y);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float xv = x[mi][half][kk];
              float& h = hh[mi][nj][half * 2 + q];
              h = fmaf(xv, wh[q], h);
              if (MODE == kBf16x2) {
                float& c = cr[mi][nj][half * 2 + q];
                c = fmaf(xv, wl[q], c);
              }
            }
      }
    }
  }
}

// A hidden layer's product in its tier: bf16x3 on mma.sync (tier_mma);
// bf16 and bf16x2 as the FMA kernel's chains.
// Those two round the x role to bf16, so an ulp of a pre can flip the next
// layer's operand by a bf16 ulp: on an H100 the tensor core's sums (in
// the tensor core or in fresh accumulators alike) flipped enough of them to
// move the rate points' bf16-tier decode 1.0-1.6e-3 from the plain
// version's, past chip_smoke.py phase 17's 1e-3.  bf16x3 splits x (hi +
// lo), which moves with the pre continuously.
template <int H>
__device__ __forceinline__ void hidden_product(
    int mode, const bf16* Xh, const bf16* Xl, int arow, int acol,
    const bf16* Wh, const bf16* Wl, int ksteps,
    float (&hh)[2][Tc<H>::NT][4], float (&cr)[2][Tc<H>::NT][4]) {
  if (mode == kBf16x3)
    tc_product<H, kBf16x3, false>(Xh, Xl, arow, acol, Wh, Wl, ksteps, hh, cr);
  else if (mode == kBf16x2)
    seq_product<H, kBf16x2>(Xh, arow, acol, Wh, Wl, ksteps, hh, cr);
  else
    seq_product<H, kBf16>(Xh, arow, acol, Wh, Wl, ksteps, hh, cr);
}

// RFF layer 0's product in its tier, on mma.sync in fresh accumulators.
template <int H>
__device__ __forceinline__ void rff_product(
    int mode, const bf16* Xh, const bf16* Xl, int arow, int acol,
    const bf16* Wh, const bf16* Wl, int ksteps,
    float (&hh)[2][Tc<H>::NT][4], float (&cr)[2][Tc<H>::NT][4]) {
  if (mode == kBf16x3)
    tc_product<H, kBf16x3, true>(Xh, Xl, arow, acol, Wh, Wl, ksteps, hh, cr);
  else if (mode == kBf16x2)
    tc_product<H, kBf16x2, true>(Xh, Xl, arow, acol, Wh, Wl, ksteps, hh, cr);
  else
    tc_product<H, kBf16, true>(Xh, Xl, arow, acol, Wh, Wl, ksteps, hh, cr);
}

// Calls f(IntC<KIND>, IntC<DEG>) for a layer's kind and trig degree, so
// that activate() runs with constants: its branches fold away and the
// epilogue's units are one straight run of code the compiler interleaves
// (tanh and linear read no degree).
template <int V>
struct IntC {
  static constexpr int value = V;
};

template <class F>
__device__ __forceinline__ void with_activation(int kind, int deg, F&& f) {
  auto sine_or_snake = [&](auto k) {
    if (deg == 7) f(k, IntC<7>{});
    else if (deg == 9) f(k, IntC<9>{});
    else if (deg == 11) f(k, IntC<11>{});
    else f(k, IntC<0>{});
  };
  if (kind == kSine) sine_or_snake(IntC<kSine>{});
  else if (kind == kSnake) sine_or_snake(IntC<kSnake>{});
  else if (kind == kTanh) f(IntC<kTanh>{}, IntC<0>{});
  else f(IntC<kLinear>{}, IntC<0>{});
}

// pre = (hh + cr) + b for the warp's 32 x WC block, activated and written
// over the block's rows of the activation planes as the next layer's x
// role (hi, lo); with pre_out also pre, for the rows below n.
template <int H, int KIND, int DEG>
__device__ __forceinline__ void tc_epilogue(
    const float (&hh)[2][Tc<H>::NT][4], const float (&cr)[2][Tc<H>::NT][4],
    const float* sb, const float* sa, float omega, bf16* Xh, bf16* Xl,
    int xrow, float* pre_out, int grow, int n) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) % C::WN * C::WC;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < C::NT; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mi * 16 + (lane >> 2) + half * 8;
        const int col = c0 + nj * 8 + (lane & 3) * 2;
        float p[2];
        bf16 hv[2], lv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          p[q] = (hh[mi][nj][half * 2 + q] + cr[mi][nj][half * 2 + q]) +
                 sb[col + q];
          split_bf16(activate(KIND, p[q], omega, sa[col + q], DEG), hv + q,
                     lv + q);
        }
        if (pre_out != nullptr && grow + r < n)
          *reinterpret_cast<float2*>(pre_out + (long long)(grow + r) * H +
                                     col) = make_float2(p[0], p[1]);
        const int idx = (xrow + r) * C::LD + col;
        *reinterpret_cast<unsigned*>(Xh + idx) =
            *reinterpret_cast<const unsigned*>(hv);
        *reinterpret_cast<unsigned*>(Xl + idx) =
            *reinterpret_cast<const unsigned*>(lv);
      }
}

template <int H>
__device__ __forceinline__ void tc_epilogue_dispatch(
    const float (&hh)[2][Tc<H>::NT][4], const float (&cr)[2][Tc<H>::NT][4],
    const float* sb, const float* sa, int kind, float omega, int deg,
    bf16* Xh, bf16* Xl, int xrow, float* pre_out, int grow, int n) {
  with_activation(kind, deg, [&](auto k, auto g) {
    tc_epilogue<H, decltype(k)::value, decltype(g)::value>(
        hh, cr, sb, sa, omega, Xh, Xl, xrow, pre_out, grow, n);
  });
}

// RFF layer 0's features k0 .. k0 + KS (zero from kn on) of rows
// [r0, r0 + nr) into columns [col0, col0 + KS) of the activation planes,
// split in the x role.
template <int H, int FDEG>
__device__ __forceinline__ void tc_features(const float* sc,
                                            const float* __restrict__ bt,
                                            int d, int F, int k0, int kn,
                                            int r0, int nr, bf16* Xh,
                                            bf16* Xl, int col0) {
  using C = Tc<H>;
  for (int e = threadIdx.x; e < nr * C::KS; e += C::THREADS) {
    const int r = r0 + e / C::KS, j = e % C::KS;
    const float v =
        j < kn ? rff_feature(sc + r * d, bt, d, F, k0 + j, FDEG) : 0.0f;
    split_bf16(v, Xh + r * C::LD + col0 + j, Xl + r * C::LD + col0 + j);
  }
}

template <int H>
__device__ __forceinline__ void tc_features_dispatch(
    int fdeg, const float* sc, const float* __restrict__ bt, int d, int F,
    int k0, int kn, int r0, int nr, bf16* Xh, bf16* Xl, int col0) {
  with_activation(kSine, fdeg, [&](auto, auto g) {
    tc_features<H, decltype(g)::value>(sc, bt, d, F, k0, kn, r0, nr, Xh, Xl,
                                       col0);
  });
}

// A raw layer 0 for the CTA's rows: pre = b + x . w0 by exact f32
// multiply-adds (the FMA kernel's), activated and split into the planes.
template <int H, int KIND, int DEG>
__device__ __forceinline__ void tc_layer0_raw(const float* sc,
                                              const float* __restrict__ w0,
                                              const float* sb, int d,
                                              float omega, int rows,
                                              bf16* Xh, bf16* Xl,
                                              float* pre_out, int row0,
                                              int n) {
  using C = Tc<H>;
  for (int e = threadIdx.x; e < rows * (H / 2); e += C::THREADS) {
    const int r = e / (H / 2), c = 2 * (e % (H / 2));
    bf16 hv[2], lv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float pre = sb[c + q];
      for (int t = 0; t < d; ++t)
        pre = pre + sc[r * d + t] * __ldg(w0 + t * H + c + q);
      if (pre_out != nullptr && row0 + r < n)
        pre_out[(long long)(row0 + r) * H + c + q] = pre;
      split_bf16(activate(KIND, pre, omega, sb[H + c + q], DEG), hv + q,
                 lv + q);
    }
    *reinterpret_cast<unsigned*>(Xh + r * C::LD + c) =
        *reinterpret_cast<const unsigned*>(hv);
    *reinterpret_cast<unsigned*>(Xl + r * C::LD + c) =
        *reinterpret_cast<const unsigned*>(lv);
  }
}

template <int H>
__global__ void __launch_bounds__(Tc<H>::THREADS, 1)
siren_stack_tc_kernel(const float* __restrict__ coords,
                      float* __restrict__ out, const LayerArgs args,
                      const PlaneArgs pa, int n, int rows, int tiles) {
  using C = Tc<H>;
  using Acc = float[2][C::NT][4];
  extern __shared__ float4 smem4[];
  bf16* Xh = reinterpret_cast<bf16*>(smem4);
  bf16* Xl = Xh + rows * C::LD;
  bf16* Ws = Xl + rows * C::LD;  // [stage][plane][KS][LD]
  float* sba = reinterpret_cast<float*>(Ws + C::NST * 2 * C::KS * C::LD);
  float* sc = sba + 4 * H;       // rows x d coordinates

  const int tid = threadIdx.x, wm = (tid >> 5) / C::WN;
  const long long win = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows;
  const int d = args.in_features, L = args.n_layers, F = args.n_freq;
  const int passes = rows / C::TP;
  // jobs: the slabs of W in the order the layers read them, RFF layer 0's
  // first; job j goes to stage j % NST
  const int n0 = F > 0 ? (2 * F + C::KS - 1) / C::KS : 0;
  const int nsl = H / C::KS;
  const int jobs = n0 + (L - 2) * nsl;

  // b and snake a of layer li into buffer li & 1 (read by its epilogue)
  auto load_ba = [&](int li) {
    float* dst = sba + (li & 1) * 2 * H;
    for (int e = tid; e < H; e += C::THREADS) {
      dst[e] = args.b[li][win * H + e];
      dst[H + e] = args.a[li] ? args.a[li][win * H + e] : 1.0f;
    }
  };
  // job j's slab in flight (no commit); the first slab of a hidden layer
  // also loads that layer's b and a
  auto issue = [&](int j) {
    if (j >= jobs) return;
    const int li = j < n0 ? 0 : 1 + (j - n0) / nsl;
    const int k0 = (j < n0 ? j : (j - n0) % nsl) * C::KS;
    const bf16* wh = pa.base + pa.off[li] + win * 2 * pa.K[li] * H;
    issue_slab<H>(Ws + (j % C::NST) * 2 * C::KS * C::LD, wh, pa.K[li], k0,
                  args.mode[li] != kBf16);
    if (li > 0 && k0 == 0) load_ba(li);
  };
  // the first jobs in flight, a commit group each: NST - 1 of streamed W,
  // layer 1's W when resident
  auto prologue = [&]() {
    for (int j = 0; j < (C::NST > 1 ? C::NST - 1 : 1); ++j) {
      issue(j);
      cp_async_commit();
    }
  };
  // the warps that share a pass's rows (ids 1..8: one warp needs none)
  auto group_sync = [&]() {
    if (C::WN == 1) __syncwarp();
    else named_barrier(1 + wm, C::WN * 32);
  };
  auto zero = [](Acc& a, Acc& b) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < C::NT; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[mi][nj][q] = b[mi][nj][q] = 0.0f;
  };

  load_ba(0);
  for (int e = tid; e < rows * d; e += C::THREADS) {
    const int row = row0 + e / d;
    sc[e] = row < n ? coords[(long long)row * d + e % d] : 0.0f;
  }
  float* pre_out = args.pre0 ? args.pre0 + win * n * H : nullptr;
  const float* sb0 = sba;
  Acc hh, cr;

  // ---- layer 0 ----
  if (F == 0) {
    // raw coordinates: exact f32 multiply-adds, W of layer 1 in flight
    prologue();
    __syncthreads();
    const float* w0 = args.w[0] + win * d * H;
    with_activation(args.kind[0], args.deg[0], [&](auto k, auto g) {
      tc_layer0_raw<H, decltype(k)::value, decltype(g)::value>(
          sc, w0, sb0, d, args.omega[0], rows, Xh, Xl, pre_out, row0, n);
    });
  } else {
    // RFF: [cos v, sin v] @ W0 by K-slabs, features computed per slab
    const int K = 2 * F, mode = args.mode[0];
    if constexpr (C::kStream) {
      // one pass; the features of slab s in columns (s & 1) * KS of the
      // planes while the other slab's are read
      prologue();
      __syncthreads();  // coords, b, a
      zero(hh, cr);
      for (int s = 0; s < n0; ++s) {
        const int k0 = s * C::KS, kn = min(C::KS, K - k0);
        tc_features_dispatch<H>(args.fdeg, sc, args.bt, d, F, k0, kn, 0,
                                rows, Xh, Xl, (s & 1) * C::KS);
        cp_async_wait<C::NST - 2>();
        __syncthreads();
        issue(s + C::NST - 1);
        cp_async_commit();
        const bf16* w = Ws + (s % C::NST) * 2 * C::KS * C::LD;
        rff_product<H>(mode, Xh, Xl, wm * 32, (s & 1) * C::KS,
                                     w, w + C::KS * C::LD,
                                     (kn + 15) / 16, hh, cr);
      }
      group_sync();
      tc_epilogue_dispatch<H>(hh, cr, sb0, sb0 + H, args.kind[0],
                              args.omega[0], args.deg[0], Xh, Xl, wm * 32,
                              pre_out, row0 + wm * 32, n);
    } else {
      // W resident: one slab stage of H rows, re-read for each pass; the
      // features of a pass's rows in its own rows of the planes
      for (int p = 0; p < passes; ++p) {
        const int pr = p * C::TP;
        zero(hh, cr);
        for (int s = 0; s < n0; ++s) {
          const int k0 = s * C::KS, kn = min(C::KS, K - k0);
          __syncthreads();  // the last slab's W and features are read
          issue(s);
          cp_async_commit();
          tc_features_dispatch<H>(args.fdeg, sc, args.bt, d, F, k0, kn, pr,
                                  C::TP, Xh, Xl, 0);
          cp_async_wait<0>();
          __syncthreads();
          rff_product<H>(mode, Xh, Xl, pr + wm * 32, 0, Ws,
                                       Ws + C::KS * C::LD, (kn + 15) / 16,
                                       hh, cr);
        }
        group_sync();
        tc_epilogue_dispatch<H>(hh, cr, sb0, sb0 + H, args.kind[0],
                                args.omega[0], args.deg[0], Xh, Xl,
                                pr + wm * 32, pre_out, row0 + pr + wm * 32,
                                n);
      }
      __syncthreads();  // W0's last slab is read
      issue(n0);
      cp_async_commit();
    }
  }

  // ---- hidden h x h layers ----
  int j = n0;  // the next job to read
  for (int li = 1; li < L - 1; ++li) {
    const int mode = args.mode[li], kind = args.kind[li], deg = args.deg[li];
    const float omega = args.omega[li];
    const float* sb = sba + (li & 1) * 2 * H;
    if constexpr (!C::kStream) {
      cp_async_wait<0>();
      __syncthreads();  // W, b, a of li landed; the previous layer written
      for (int p = 0; p < passes; ++p) {
        const int xrow = p * C::TP + wm * 32;
        zero(hh, cr);
        hidden_product<H>(
            mode, Xh, Xl, xrow, 0, Ws, Ws + C::KS * C::LD, H / 16, hh, cr);
        if (p + 1 < passes) {
          group_sync();
        } else {
          __syncthreads();  // every pass has read W: the next layer's in
          issue(j + 1);
          cp_async_commit();
        }
        tc_epilogue_dispatch<H>(hh, cr, sb, sb + H, kind, omega, deg, Xh,
                                Xl, xrow, nullptr, 0, 0);
      }
      ++j;
    } else {
      zero(hh, cr);
      for (int s = 0; s < nsl; ++s, ++j) {
        cp_async_wait<C::NST - 2>();
        __syncthreads();  // slab j landed; slab j - 1's stage is read
        issue(j + C::NST - 1);
        cp_async_commit();
        const bf16* w = Ws + (j % C::NST) * 2 * C::KS * C::LD;
        hidden_product<H>(
            mode, Xh, Xl, wm * 32, s * C::KS, w, w + C::KS * C::LD,
            C::KS / 16, hh, cr);
      }
      group_sync();
      tc_epilogue_dispatch<H>(hh, cr, sb, sb + H, kind, omega, deg, Xh, Xl,
                              wm * 32, nullptr, 0, 0);
    }
  }
  cp_async_wait<0>();

  // ---- head: h -> 1, the FMA kernel's reduction over h (H / 32 threads a
  // row, each a strided chain, then a butterfly) ----
  __syncthreads();
  {
    const int li = L - 1, mode = args.mode[li];
    constexpr int tpr = H / 32;
    const float* __restrict__ wg = args.w[li] + win * H;
    for (int r = tid / tpr; r < rows; r += C::THREADS / tpr) {
      const int s = tid % tpr;
      float acc = 0.0f, acc2 = 0.0f;
      for (int c = s; c < H; c += tpr) {
        const float w = __ldg(wg + c), wh = bf16r(w), wl = bf16r(w - wh);
        const float xh = __bfloat162float(Xh[r * C::LD + c]);
        acc = fmaf(xh, wh, acc);
        if (mode == kBf16x2 || mode == kBf16x3) acc2 = fmaf(xh, wl, acc2);
        if (mode == kBf16x3)
          acc2 = fmaf(__bfloat162float(Xl[r * C::LD + c]), wh, acc2);
      }
#pragma unroll
      for (int off = tpr / 2; off > 0; off /= 2) {
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

template <int H>
int launch_tc(const LayerArgs& args, PlaneArgs pa, const float* coords,
              float* out, bf16* planes, long long plane_elems, int k, int n,
              int rows, cudaStream_t stream) {
  using C = Tc<H>;
  if (rows < C::TP || rows % C::TP || rows > C::max_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  // the planes: RFF layer 0's (2F rows), then each hidden layer's (H rows)
  const int l0 = args.n_freq > 0 ? 0 : 1, l1 = args.n_layers - 1;
  long long off = 0;
  int most = 0;  // the most rows of a layer's W
  for (int li = l0; li < l1; ++li) {
    pa.K[li] = li == 0 ? 2 * args.n_freq : H;
    pa.off[li] = off;
    off += 2LL * k * pa.K[li] * H;
    most = pa.K[li] > most ? pa.K[li] : most;
  }
  if (off > plane_elems) return static_cast<int>(cudaErrorInvalidValue);
  pa.base = planes;
  if (l1 > l0) {
    const int bpw = (most * H / 4 + kThreads - 1) / kThreads;
    if (static_cast<long long>(k) * bpw > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    siren_stack_split_kernel<<<dim3(k * bpw, l1 - l0), kThreads, 0,
                               stream>>>(args, pa, planes, H, l0, bpw);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  const size_t smem = C::smem_bytes(rows);
  cudaError_t e = cudaFuncSetAttribute(
      siren_stack_tc_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + rows - 1) / rows;
  const long long blocks = static_cast<long long>(tiles) * k;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  siren_stack_tc_kernel<H><<<static_cast<unsigned>(blocks), C::THREADS,
                             smem, stream>>>(coords, out, args, pa, n, rows,
                                             tiles);
  return static_cast<int>(cudaGetLastError());
}

// The arguments shared by both entry points into `args`; false where they
// are out of range.
bool parse_args(LayerArgs& args, const void* ptrs, const void* ints,
                const void* omegas, int n_layers, int k, int n, int d,
                const void* bt, int n_freq, int fdeg, void* pre0) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn || k < 1 ||
      n < 1 || n_freq < 0 || (n_freq > 0) != (bt != nullptr))
    return false;
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
  return true;
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
  LayerArgs args;
  if (!parse_args(args, ptrs, ints, omegas, n_layers, k, n, d, bt, n_freq,
                  fdeg, pre0))
    return static_cast<int>(cudaErrorInvalidValue);
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

// The tensor-core route: the arguments of siren_stack_forward, every
// product layer's mode (layers 1+, and layer 0 with n_freq > 0) bf16,
// bf16x2 or bf16x3; planes: device bf16 scratch of plane_elems elements,
// at least k * 2 * h * (2 * n_freq + (n_layers - 2) * h); rows: rows of a
// window a CTA covers (ops/siren_fused.py: stack_launch).  Two launches:
// the weight split, then the stack.
int siren_stack_forward_tc(const void* coords, void* out, const void* ptrs,
                           const void* ints, const void* omegas,
                           int n_layers, int k, int n, int d, int h,
                           const void* bt, int n_freq, int fdeg, void* pre0,
                           void* planes, long long plane_elems, int rows,
                           void* stream) {
  LayerArgs args;
  if (!parse_args(args, ptrs, ints, omegas, n_layers, k, n, d, bt, n_freq,
                  fdeg, pre0))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int li = n_freq > 0 ? 0 : 1; li < n_layers; ++li)
    if (args.mode[li] == kHighest)
      return static_cast<int>(cudaErrorInvalidValue);
  PlaneArgs pa{};
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  bf16* pl = static_cast<bf16*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32:
      return launch_tc<32>(args, pa, c, o, pl, plane_elems, k, n, rows, s);
    case 64:
      return launch_tc<64>(args, pa, c, o, pl, plane_elems, k, n, rows, s);
    case 128:
      return launch_tc<128>(args, pa, c, o, pl, plane_elems, k, n, rows, s);
    case 256:
      return launch_tc<256>(args, pa, c, o, pl, plane_elems, k, n, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
