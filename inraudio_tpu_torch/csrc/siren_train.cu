// SirenWithSnakeTanh training kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces four Pallas TPU kernels of the JAX package, with the RFF layer 0
// they share (inraudio_tpu/ops/pallas_siren.py:_rff_features_in_kernel):
//   inraudio_tpu/ops/pallas_siren_step.py:_step_kernel  (kernel D: the whole
//       MSE step: forward recompute, masked MSE, backward, global-norm clip,
//       Adam, best-params snapshot, in place)
//   inraudio_tpu/ops/pallas_siren_train.py:_bwd_kernel  (kernel C: the
//       backward of the stack for a supplied cotangent)
//   inraudio_tpu/ops/pallas_siren_step.py:_grad_kernel  (kernel E: one row
//       shard's masked MSE loss and grads, for the row-sharded fit)
//   inraudio_tpu/ops/pallas_siren_step.py:_adam_kernel  (kernel F: clip +
//       Adam + best on the all-reduced grads of the row-sharded fit)
// In the bf16, bf16x2 and bf16x3 tiers the grad accumulation runs on the
// tensor cores (siren_wsplit_kernel, siren_sweep_kernel, siren_dw_kernel:
// see "The tensor-core route" below); the highest tier, and every kernel
// below, as follows:
//   siren_grad_kernel   per (window, row slice): for each row tile of the
//                       slice in order, the forward recompute, the cotangent
//                       (D: 2 (out - tgt) / n on valid rows, and the tile's
//                       loss; C: the supplied cotangent), the backward sweep,
//                       and that tile's dW / db / da added to the slice's own
//                       slab of a global partial-grad buffer;
//   siren_reduce_kernel per (window, 1024-float chunk): the window's slabs
//                       summed in slice order, and the chunk's sum of squares;
//   siren_scale_kernel  one CTA per window: the window's norm and loss
//                       from the chunk / slice partials, summed once in
//                       index order, -> its clip scale and loss (D);
//   siren_adam_kernel   per (window, 4096-float span): clip, Adam and the
//                       best snapshot of the OLD params, in place, as float4
//                       streams, four float4 a thread in flight (D);
//   siren_adam_global_kernel  F in one cooperative launch: each 1024-float
//                       chunk's sum of squares as the reduce computes it, a
//                       grid-wide sync, the norm summed in chunk order by
//                       every CTA, then the same update over the chunks.
// D and E take an optional per-row loss weight (TrainArgs::wgt, (k, n) like
// the targets; the mdct target's hearing-threshold mask): the prologue
// computes l = (err err) w and g = err (w 2/n), the plain version's order,
// so a weight of ones gives the unweighted bits.  C's cotangent takes none.
// C is grad + reduce; D is grad + reduce + scale + Adam.  E is grad + reduce
// with a device row limit (rows at or past it carry no loss), the
// normaliser the whole clip's 1 / n_valid from the host, and the shard's
// loss summed by the reduce into the slot after its grads: one buffer
// [grads (P) | loss | pad] that the fit all-reduces across ranks.  F reads
// that buffer: the norm and the loss come from the all-reduced values,
// never from a rank's own partials, so every rank clips by the global norm
// and applies the same update.
//
// What bounds it on an H100 (by reading): per sample at h = 128 the step is
// ~197k forward multiply-adds (bf16x3: three bf16 passes) plus ~262k
// backward (4 hidden layers x 2 products x 2 passes at the default bf16x2
// grad tier); at h = 256 four times that, and an F = 256 RFF layer 0 adds
// ~0.65M.  On the 989 TFLOP/s bf16 tensor cores that is the bound (1.1 ms a
// runner mlp step of 308,207 rows); with every product as fp32 FMAs on CUDA
// cores (siren_grad_kernel) the step took 65 ms.  The tensor-core route
// keeps the forward and the dgrad's hi.hi as fp32 FMAs in the reference's
// order (see "The tensor-core route"), so its sweep is bound by those FMAs
// and by its elementwise phases, not by the tensor cores.  The reduce and
// Adam passes are memory bound.
//
// Design choices (the TPU kernel kept 7-9 copies of a window's parameters
// plus every layer's (input, pre) pair in 16 MB of VMEM; a block here has
// 227 KB, and one window's f32 parameters alone are 266.8 KB at h = 128):
// - one CTA per (window, row slice); a slice is a run of row tiles of TM =
//   8192 / h rows, as the stack kernel's: the activation tile stays in
//   shared memory and each layer's W streams in by K-slabs (slab_rows<H>:
//   the whole W up to h = 128, 64 rows at h = 256); the dgrad product reads
//   W transposed, written to shared memory through 4 x 4 register
//   transposes, slab by slab;
// - RFF layer 0: the features are recomputed per tile and per K-slab from
//   the coordinates, in the forward and again for dW0 = [cos; sin]^T gpre0
//   (no dgrad below layer 0, no gradient for B); never saved;
// - only each layer's pre-activation is saved, in an L2-sized global scratch
//   private to the CTA (L x 32 KB); a layer's input is recomputed from the
//   previous layer's pre when the backward needs it;
// - determinism: no float atomics anywhere.  Each CTA writes its own slab
//   of partial grads (its first tile stores, later tiles add, in tile
//   order); the reduce sums slabs in slice order, block sums use fixed
//   trees, and the norm / loss are summed in a fixed order.  Two steps from
//   the same state give bit-identical states;
// - bounded scratch: a window of more row tiles than kMaxSlices goes
//   through kMaxSlices slices (ops/siren_train.py, MAX_SLICES), so its
//   slabs and saved pres take at most kMaxSlices x (P + 8192 L) floats
//   whatever its length; a window of fewer tiles keeps one tile per slice.
//   The slice count depends on the shapes only, so the wrappers' grouping
//   of windows within SCRATCH_BYTES leaves every result bit-equal;
// - grid-wide parallelism: slices x windows CTAs (8 per window at the
//   headline, 173 at the codec default, 264 for one model over a clip or
//   over one shard of it);
// - E is bit-deterministic per shard: its slices depend on the shard's own
//   row tiles, and its limit is read once per thread from device memory (no
//   host sync).  F is elementwise after a fixed-order norm, so ranks that
//   hold the same all-reduced buffer and state stay bit-equal.  F must
//   move 7 P floats (g, p, mu, nu read; p, mu, nu written), 8 P when the
//   loss improves and best takes the old p (best is never read): it is
//   bound by bytes, a few microseconds at the runner shapes.
// - widths between the kernel widths (36, 40, 48 of the codec's rate
//   points): the wrappers zero-pad the model to the next H once per fit,
//   and the kernel takes the model's own width h_real.  Every hidden unit
//   at or past it outputs exactly 0, in the forward and where the backward
//   recomputes its input from the saved pre.  Zero weights alone are not
//   enough: a padded snake unit has pre = 0, and the polynomial cos(0) is
//   not 1 (snake(0) = -9.2e-5 at degree 7, +6.0e-8 at degree 11), so the
//   next layer's dW rows for it would be non-zero.  With the mask every
//   padded slot gets an exact zero gradient, Adam keeps it at zero, and
//   the loss and clip norm are the unpadded model's.  At h_real = H the
//   mask is never taken and every result is bit-equal to the unmasked
//   kernel's.
//
// Numerics, as the JAX package (and the plain versions in
// inraudio_tpu_torch/ops/siren_train.py and siren_step.py):
// - forward: raw layer 0 exact f32 multiply-adds, RFF layer 0 its features
//   in the forward tier; layers 1+ in their forward tier (f32_mode, default
//   bf16x3), as siren_stack.cu;
// - backward: one grad tier for both products (INRAUDIO_GRAD_PRECISION,
//   default bf16x2): dW = x_in^T gpre rounds x_in (and splits it in bf16x3)
//   and splits gpre; dgrad = gpre W^T rounds gpre and splits W.  Layer 0's
//   dW is the same grad-tier product of the raw coordinates, or of the RFF
//   features;
// - sine: gpre = g * (omega * cos(omega * pre)); snake: gpre = g * (1 +
//   sin 2a pre), da = sum_rows ((-0.5 / a^2)(1 - cos 2a pre) + (pre / a)
//   sin 2a pre) * g; tanh: g * (1 - t^2); sin / cos of the forward's degree;
// - Adam as torch.optim.Adam: m = 0.9 m + 0.1 g, v = 0.999 v + (0.001 g) g,
//   p - lr (m / c1) / (sqrt(v / c2) + 1e-8), op by op (-fmad=false, no fast
//   math), with c1 = 1 - 0.9^t and c2 = 1 - 0.999^t per window from the host.

#include <algorithm>

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace {

constexpr int kTileFloats = 8192;  // TM * H at every width
constexpr int kChunk = 1024;       // floats per CTA of the reduce, F's chunk

struct TrainArgs {
  int off_w[kMaxLayers];  // leaf offsets in a window's flat vector
  int off_b[kMaxLayers];
  int off_a[kMaxLayers];  // -1: no snake a
  int kind[kMaxLayers];
  int mode[kMaxLayers];   // forward matmul tier (RFF layer 0: its tier)
  int deg[kMaxLayers];    // 0 = exact sinf / cosf
  float omega[kMaxLayers];
  int n_layers;
  int d;                  // raw input columns
  int P;                  // floats per window (multiple of 4)
  int gmode;              // backward matmul tier
  float inv_n, two_inv_n;
  const float* bt;        // RFF: 2 pi B^T (d, F), or null
  int n_freq;             // F (0: raw layer 0)
  int fdeg;               // the RFF features' trig degree
  int h_real;             // the model's own width: units at or past it
                          // (zero padding up to H) output exactly 0
  const float* wgt;       // D / E: per-row loss weight (k, n), or null
};

template <int H>
__host__ __device__ constexpr int wgrad_splits() {
  // row groups of the dW product: (H*H/32) 4x8 output tiles over 256 threads
  return (H * H / 32) >= kThreads ? 1 : kThreads / (H * H / 32);
}

template <int H>
__host__ __device__ constexpr int region1_floats() {
  // W slab planes (forward), x_in planes / W^T slab planes / dX (backward)
  return (2 * slab_rows<H>() * H > 2 * tile_rows<H>() * (H + 4))
             ? 2 * slab_rows<H>() * H
             : 2 * tile_rows<H>() * (H + 4);
}

template <int H>
__host__ __device__ constexpr size_t train_smem_floats() {
  return region1_floats<H>()                            // R1
         + 2 * tile_rows<H>() * (H + 4)                 // R2: X / gpre planes
         + (wgrad_splits<H>() - 1) * 2 * H * H          // R3: dW row groups
         + 2 * H                                        // bias, snake a
         + tile_rows<H>() * kMaxIn                      // coordinates
         + 5 * tile_rows<H>()                           // head pre/gpre, loss
         + 2 * kThreads;                                // column sums
}

static_assert(train_smem_floats<32>() * 4 <= 232448, "smem h=32");
static_assert(train_smem_floats<64>() * 4 <= 232448, "smem h=64");
static_assert(train_smem_floats<128>() * 4 <= 232448, "smem h=128");
static_assert(train_smem_floats<256>() * 4 <= 232448, "smem h=256");

// Derivative of the layer's activation: returns gpre; the snake also
// returns its da term in *ga.
__device__ __forceinline__ float dact(int kind, float pre, float omega,
                                      float a, int deg, float g, float* ga) {
  if (kind == kSine) return g * (omega * trig_cos(omega * pre, deg));
  if (kind == kSnake) {
    const float s2 = trig_sin((2.0f * a) * pre, deg);
    const float c2 = trig_cos((2.0f * a) * pre, deg);
    *ga = (-(0.5f / (a * a)) * (1.0f - c2) + (pre / a) * s2) * g;
    return g * (1.0f + s2);
  }
  if (kind == kTanh) {
    const float t = tanhf(pre);
    return g * (1.0f - t * t);
  }
  return g;
}

// acc[i][c] (+ acc2) += sum_r A[r, j0 + i] * B[r, col(c)] over rows
// [rb, re): the dW product x_in^T gpre.  A = x_in planes (rounded side),
// B = gpre planes (split side), both (TM, H + 4) row-major.
template <int H, int MODE>
__device__ __forceinline__ void wgrad_tile(const float* Ahi, const float* Alo,
                                           const float* Bhi, const float* Blo,
                                           int rb, int re, int j0, int c0,
                                           int c1, float (&acc)[4][8],
                                           float (&acc2)[4][8]) {
  constexpr int LD = H + 4;
#pragma unroll 1
  for (int r = rb; r < re; ++r) {
    const float4 xh = *reinterpret_cast<const float4*>(Ahi + r * LD + j0);
    float4 xl = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE == kBf16x3) xl = *reinterpret_cast<const float4*>(Alo + r * LD + j0);
    const float4 b0 = *reinterpret_cast<const float4*>(Bhi + r * LD + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(Bhi + r * LD + c1);
    const float gh[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float gl[8];
    if (MODE == kBf16x2 || MODE == kBf16x3) {
      const float4 l0 = *reinterpret_cast<const float4*>(Blo + r * LD + c0);
      const float4 l1 = *reinterpret_cast<const float4*>(Blo + r * LD + c1);
      gl[0] = l0.x; gl[1] = l0.y; gl[2] = l0.z; gl[3] = l0.w;
      gl[4] = l1.x; gl[5] = l1.y; gl[6] = l1.z; gl[7] = l1.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = lane(xh, i);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[i][c] = fmaf(xv, gh[c], acc[i][c]);
        if (MODE == kBf16x2 || MODE == kBf16x3)
          acc2[i][c] = fmaf(xv, gl[c], acc2[i][c]);
      }
      if (MODE == kBf16x3) {
        const float xlv = lane(xl, i);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc2[i][c] = fmaf(xlv, gh[c], acc2[i][c]);
      }
    }
  }
}

template <int H>
__device__ __forceinline__ void wgrad_dispatch(int mode, const float* Ahi,
                                               const float* Alo,
                                               const float* Bhi,
                                               const float* Blo, int rb,
                                               int re, int j0, int c0, int c1,
                                               float (&acc)[4][8],
                                               float (&acc2)[4][8]) {
  if (mode == kBf16x3)
    wgrad_tile<H, kBf16x3>(Ahi, Alo, Bhi, Blo, rb, re, j0, c0, c1, acc, acc2);
  else if (mode == kBf16x2)
    wgrad_tile<H, kBf16x2>(Ahi, Alo, Bhi, Blo, rb, re, j0, c0, c1, acc, acc2);
  else if (mode == kBf16)
    wgrad_tile<H, kBf16>(Ahi, Alo, Bhi, Blo, rb, re, j0, c0, c1, acc, acc2);
  else
    wgrad_tile<H, kHighest>(Ahi, Alo, Bhi, Blo, rb, re, j0, c0, c1, acc, acc2);
}

// The rounded ("x") side of a grad-tier product: hi, and lo for bf16x3.
__device__ __forceinline__ void xsplit(float v, int mode, float* hi,
                                       float* lo) {
  if (mode == kHighest) {
    *hi = v;
    *lo = 0.0f;
    return;
  }
  *hi = bf16r(v);
  *lo = mode == kBf16x3 ? bf16r(v - *hi) : 0.0f;
}

// The split ("w") side: hi, and lo for bf16x2 / bf16x3.
__device__ __forceinline__ void wsplit(float v, int mode, float* hi,
                                       float* lo) {
  if (mode == kHighest) {
    *hi = v;
    *lo = 0.0f;
    return;
  }
  *hi = bf16r(v);
  *lo = mode == kBf16 ? 0.0f : bf16r(v - *hi);
}

// One product of the grad tier from split operands, summed as the JAX
// package does: hi*hi + (hi*lo + lo*hi).
__device__ __forceinline__ float tier_mul(float xh, float xl, float wh,
                                          float wl, int mode) {
  if (mode == kHighest || mode == kBf16) return xh * wh;
  if (mode == kBf16x2) return xh * wh + xh * wl;
  return xh * wh + (xh * wl + xl * wh);
}

// A slice's slab entry: its first tile stores, later tiles add in order.
__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// put of a group's tiles in order, v[0 .. n): one read, one write
template <int N>
__device__ __forceinline__ void put_group(float* p, const float (&v)[N],
                                          int n, bool first) {
  float s = first ? v[0] : *p + v[0];
#pragma unroll
  for (int g = 1; g < N; ++g)
    if (g < n) s = s + v[g];
  *p = s;
}

__device__ __forceinline__ void put4(float* p, float4 v, bool first) {
  if (!first) {
    const float4 o = *reinterpret_cast<const float4*>(p);
    v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
  }
  *reinterpret_cast<float4*>(p) = v;
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_grad_kernel(const float* __restrict__ coords,
                  const float* __restrict__ params,
                  float* __restrict__ partial, float* __restrict__ loss_part,
                  float* __restrict__ pre_buf, const float* __restrict__ tgt,
                  const float* __restrict__ cot,
                  const int* __restrict__ limit, const TrainArgs args, int n,
                  int tiles, int slices) {
  constexpr int TM = tile_rows<H>();
  constexpr int LD = H + 4;
  constexpr int KS = slab_rows<H>();
  constexpr int CG = H / 8;            // column groups of 2 x 4 columns
  constexpr int TPR = kThreads / TM;   // head forward: threads per row
  constexpr int TPC = kThreads / H;    // column passes: threads per column
  constexpr int S = wgrad_splits<H>();
  constexpr int R1 = region1_floats<H>();
  extern __shared__ float4 smem4[];
  float* r1 = reinterpret_cast<float*>(smem4);
  float* Xhi = r1 + R1;                // R2: X planes, then gpre planes
  float* Xlo = Xhi + TM * LD;
  float* r3 = Xlo + TM * LD;
  float* sb = r3 + (S - 1) * 2 * H * H;
  float* sa = sb + H;
  float* sc = sa + H;
  float* shp = sc + TM * kMaxIn;       // head pre
  float* shg = shp + TM;               // head gpre (f32)
  float* shh = shg + TM;               // head gpre hi
  float* shl = shh + TM;               // head gpre lo
  float* sl = shl + TM;                // per-row loss
  float* red = sl + TM;                // 2 * kThreads column partials

  const int tid = threadIdx.x;
  const long long win = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const int t_begin = static_cast<int>(static_cast<long long>(slice) * tiles /
                                       slices);
  const int t_end = static_cast<int>(static_cast<long long>(slice + 1) *
                                     tiles / slices);
  const int d = args.d;
  const int L = args.n_layers;
  const int gm = args.gmode;
  const int F = args.n_freq;
  const float* wp = params + win * args.P;
  float* slab = partial + static_cast<long long>(blockIdx.x) * args.P;
  float* pre_tile = pre_buf + static_cast<long long>(blockIdx.x) * L * kTileFloats;
  const int cg = tid % CG;
  const int r0 = (tid / CG) * 4;
  const int c0 = cg * 4, c1 = H / 2 + cg * 4;
  const int ec = tid % H, es = tid / H;  // column-pass mapping
  const int LH = L - 1;
  // E: rows at or past the device row limit carry no loss (null: every row)
  const int n_lim = limit != nullptr ? min(n, __ldg(limit)) : n;

  // zero the pads between leaves of this slab (the reduce sums all P;
  // no tile writes a pad)
  if (tid == 0) {
    for (int li = 0; li < L; ++li) {
      const int in_f = li == 0 ? (F > 0 ? 2 * F : d) : H;
      const int out_f = li == L - 1 ? 1 : H;
      int ends[3] = {args.off_w[li] + in_f * out_f, args.off_b[li] + out_f,
                     args.off_a[li] >= 0 ? args.off_a[li] + out_f : -1};
      for (int q = 0; q < 3; ++q)
        for (int e = ends[q]; e >= 0 && (e & 3); ++e) slab[e] = 0.0f;
    }
  }
  float loss_acc = 0.0f;  // thread 0: the slice's loss

  // x_in planes of layer li (act of layer li-1, rounded side) into r1
  auto build_xin = [&](int li) {
    const int pl = li - 1;
    const float* pt = pre_tile + pl * kTileFloats;
    const int kind = args.kind[pl], deg = args.deg[pl];
    const float omega = args.omega[pl];
    const float a = args.off_a[pl] >= 0 ? wp[args.off_a[pl] + ec] : 1.0f;
    for (int r = es; r < TM; r += TPC) {
      const float x = ec < args.h_real
                          ? activate(kind, pt[r * H + ec], omega, a, deg)
                          : 0.0f;
      xsplit(x, gm, r1 + r * LD + ec, r1 + TM * LD + r * LD + ec);
    }
  };

  // dW rows [0, R) += A^T gpre, A = the r1 planes (R columns), gpre = the
  // R2 planes; rows from kn on are padding and are not written
  auto wgrad = [&](int R, int kn, float* dw, bool first) {
    constexpr int T = H * H / 32;              // 4 x 8 output tiles of H rows
    constexpr int TT = T < kThreads ? T : kThreads;
    const int TR = R * H / 32;                 // live tiles of R rows
    const int s = tid / TT;                    // row group
    const int rb = s * (TM / S), re = rb + TM / S;
    for (int base = 0; base < T; base += TT) {
      const int tile = base + tid % TT;
      const bool live = tile < TR;
      const int tc = tile % CG, tj = tile / CG;
      const int j0 = tj * 4, wc0 = tc * 4, wc1 = H / 2 + tc * 4;
      float acc[4][8], acc2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
      if (live)
        wgrad_dispatch<H>(gm, r1, r1 + TM * LD, Xhi, Xlo, rb, re, j0, wc0,
                          wc1, acc, acc2);
      if (S > 1) {
        if (s > 0 && live) {
          float* dst = r3 + ((s - 1) * T + tile) * 64;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              dst[i * 8 + c] = acc[i][c];
              dst[32 + i * 8 + c] = acc2[i][c];
            }
        }
        __syncthreads();
        if (s == 0 && live) {
          for (int q = 1; q < S; ++q) {
            const float* src = r3 + ((q - 1) * T + tile) * 64;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                acc[i][c] += src[i * 8 + c];
                acc2[i][c] += src[32 + i * 8 + c];
              }
          }
        }
      }
      if (s == 0 && live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + i >= kn) continue;
          float* rowp = dw + (j0 + i) * H;
          put4(rowp + wc0, make_float4(
              acc[i][0] + acc2[i][0], acc[i][1] + acc2[i][1],
              acc[i][2] + acc2[i][2], acc[i][3] + acc2[i][3]), first);
          put4(rowp + wc1, make_float4(
              acc[i][4] + acc2[i][4], acc[i][5] + acc2[i][5],
              acc[i][6] + acc2[i][6], acc[i][7] + acc2[i][7]), first);
        }
      }
    }
  };

  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    const int row0 = t * TM;
    __syncthreads();  // the previous tile is done with shared memory

    // ================= forward recompute, saving each pre =================
    {
      for (int e = tid; e < H; e += kThreads) {
        sb[e] = wp[args.off_b[0] + e];
        sa[e] = args.off_a[0] >= 0 ? wp[args.off_a[0] + e] : 1.0f;
      }
      for (int e = tid; e < TM * d; e += kThreads) {
        const int row = row0 + e / d;
        sc[e] = row < n ? coords[(long long)row * d + e % d] : 0.0f;
      }
      const int kind = args.kind[0], deg = args.deg[0], next = args.mode[1];
      const float omega = args.omega[0];
      if (F > 0) {
        float acc[4][8], acc2[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
        rff_layer0<H>(wp + args.off_w[0], args.bt, sc, d, F, args.fdeg,
                      args.mode[0], r1, r1 + KS * H, Xhi, Xlo, r0, c0, c1,
                      acc, acc2);
        __syncthreads();  // every thread has read the features
        store_tile<H>(acc, acc2, sb, sa, kind, omega, deg, next, Xhi, Xlo,
                      r0, c0, c1, pre_tile, 0, TM, args.h_real);
      } else {
        const float* w0 = wp + args.off_w[0];
        for (int e = tid; e < d * H; e += kThreads) r1[e] = w0[e];
        __syncthreads();
        for (int e = tid; e < TM * H; e += kThreads) {
          const int r = e / H, c = e % H;
          float pre = sb[c];
          for (int q = 0; q < d; ++q) pre = pre + sc[r * d + q] * r1[q * H + c];
          pre_tile[e] = pre;
          split_store(c < args.h_real ? activate(kind, pre, omega, sa[c], deg)
                                      : 0.0f,
                      next, Xhi, Xlo, r * LD + c);
        }
      }
    }
    for (int li = 1; li < L - 1; ++li) {
      const int mode = args.mode[li];
      float acc[4][8], acc2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
      for (int k0 = 0; k0 < H; k0 += KS) {
        __syncthreads();
        load_split(wp + args.off_w[li] + k0 * H, r1, r1 + KS * H, KS * H,
                   mode);
        if (k0 == 0) {
          for (int e = tid; e < H; e += kThreads) {
            sb[e] = wp[args.off_b[li] + e];
            sa[e] = args.off_a[li] >= 0 ? wp[args.off_a[li] + e] : 1.0f;
          }
        }
        __syncthreads();
        dense_dispatch<H>(mode, Xhi + k0, Xlo + k0, r1, r1 + KS * H, r0, c0,
                          c1, acc, acc2, KS);
      }
      __syncthreads();
      store_tile<H>(acc, acc2, sb, sa, args.kind[li], args.omega[li],
                    args.deg[li], args.mode[li + 1], Xhi, Xlo, r0, c0, c1,
                    pre_tile + li * kTileFloats, 0, TM, args.h_real);
    }
    // head: h -> 1, then the cotangent
    {
      const int mode = args.mode[LH];
      __syncthreads();
      load_split(wp + args.off_w[LH], r1, r1 + KS * H, H, mode);
      __syncthreads();
      const int r = tid / TPR, s = tid % TPR;
      const float* xh = Xhi + r * LD;
      const float* xl = Xlo + r * LD;
      float acc = 0.0f, acc2 = 0.0f;
      for (int j = s; j < H; j += TPR) {
        acc = fmaf(xh[j], r1[j], acc);
        if (mode == kBf16x2 || mode == kBf16x3)
          acc2 = fmaf(xh[j], r1[KS * H + j], acc2);
        if (mode == kBf16x3) acc2 = fmaf(xl[j], r1[j], acc2);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
      }
      if (s == 0) {
        const int row = row0 + r;
        const float pre = (acc + acc2) + wp[args.off_b[LH]];
        const float a = args.off_a[LH] >= 0 ? wp[args.off_a[LH]] : 1.0f;
        const float out = activate(args.kind[LH], pre, args.omega[LH], a,
                                   args.deg[LH]);
        float g = 0.0f, l = 0.0f;
        if (row < n_lim) {
          if (cot != nullptr) {
            g = cot[win * n + row];
          } else {
            // the plain version's order: (err err) w and err (w 2/n); no
            // weight is w = 1, which gives the unweighted bits
            const float err = out - tgt[win * n + row];
            const float w = args.wgt != nullptr ? args.wgt[win * n + row]
                                                : 1.0f;
            l = err * err * w;
            g = err * (w * args.two_inv_n);
          }
        }
        shp[r] = pre;
        shg[r] = g;
        sl[r] = l;
      }
    }
    __syncthreads();
    if (tid == 0 && cot == nullptr) {
      float s = 0.0f;
      for (int r = 0; r < TM; ++r) s += sl[r];
      loss_acc = first ? s * args.inv_n : loss_acc + s * args.inv_n;
    }

    // ================= backward =================
    // head backward: gpre, db, dW (h x 1) and dX (TM x h) into r1
    {
      const int kind = args.kind[LH];
      const float a = args.off_a[LH] >= 0 ? wp[args.off_a[LH]] : 1.0f;
      for (int r = tid; r < TM; r += kThreads) {  // one row per thread
        float ga = 0.0f;
        const float gp = dact(kind, shp[r], args.omega[LH], a, args.deg[LH],
                              shg[r], &ga);
        shg[r] = gp;
        shp[r] = ga;  // the pre is not needed again
        wsplit(gp, gm, shh + r, shl + r);
      }
      build_xin(LH);
      __syncthreads();
      if (tid == 0) {
        float db = 0.0f, da = 0.0f;
        for (int r = 0; r < TM; ++r) {
          db += shg[r];
          da += shp[r];
        }
        put(slab + args.off_b[LH], db, first);
        if (args.off_a[LH] >= 0) put(slab + args.off_a[LH], da, first);
      }
      // dW[j] = sum_r x_in[r, j] * gpre[r]
      float acc = 0.0f, acc2 = 0.0f;
      for (int r = es; r < TM; r += TPC) {
        const float xh = r1[r * LD + ec], xl = r1[TM * LD + r * LD + ec];
        acc = fmaf(xh, shh[r], acc);
        if (gm == kBf16x2 || gm == kBf16x3) acc2 = fmaf(xh, shl[r], acc2);
        if (gm == kBf16x3) acc2 = fmaf(xl, shh[r], acc2);
      }
      red[es * H + ec] = acc;
      red[kThreads + es * H + ec] = acc2;
      __syncthreads();
      if (es == 0) {
        float s1 = red[ec], s2 = red[kThreads + ec];
        for (int q = 1; q < TPC; ++q) {
          s1 += red[q * H + ec];
          s2 += red[kThreads + q * H + ec];
        }
        put(slab + args.off_w[LH] + ec, s1 + s2, first);
      }
      // dX[r, j] = gpre[r] * W[j]
      float wh, wl;
      wsplit(wp[args.off_w[LH] + ec], gm, &wh, &wl);
      for (int r = es; r < TM; r += TPC) {
        float gh, gl;
        xsplit(shg[r], gm, &gh, &gl);
        r1[r * LD + ec] = tier_mul(gh, gl, wh, wl, gm);
      }
      __syncthreads();
    }

    // hidden layers, last to first; then layer 0
    for (int li = L - 2; li >= 0; --li) {
      // ---- phase A: gpre = dX * act'(pre) into the R2 planes; db, da ----
      {
        const float* pt = pre_tile + li * kTileFloats;
        const int kind = args.kind[li], deg = args.deg[li];
        const float omega = args.omega[li];
        const float a = args.off_a[li] >= 0 ? wp[args.off_a[li] + ec] : 1.0f;
        float db = 0.0f, da = 0.0f;
        for (int r = es; r < TM; r += TPC) {
          float ga = 0.0f;
          const float gp = dact(kind, pt[r * H + ec], omega, a, deg,
                                r1[r * LD + ec], &ga);
          db += gp;
          da += ga;
          wsplit(gp, gm, Xhi + r * LD + ec, Xlo + r * LD + ec);
        }
        red[es * H + ec] = db;
        red[kThreads + es * H + ec] = da;
        __syncthreads();
        if (es == 0) {
          float s1 = red[ec], s2 = red[kThreads + ec];
          for (int q = 1; q < TPC; ++q) {
            s1 += red[q * H + ec];
            s2 += red[kThreads + q * H + ec];
          }
          put(slab + args.off_b[li] + ec, s1, first);
          if (args.off_a[li] >= 0) put(slab + args.off_a[li] + ec, s2, first);
        }
      }
      if (li == 0) break;
      // ---- phase B: x_in planes into r1 (dX is consumed) ----
      __syncthreads();
      build_xin(li);
      __syncthreads();
      // ---- phase C: dW = x_in^T gpre ----
      wgrad(H, H, slab + args.off_w[li], first);
      // ---- phases D + E: dX = gpre W^T, W^T by K-slabs into r1 ----
      {
        float acc[4][8], acc2[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.0f;
        const float* w = wp + args.off_w[li];
        float* th = r1;
        float* tl = r1 + KS * H;
        constexpr int NBJ = H / 4, NBC = KS / 4;  // 4 x 4 blocks
        for (int k0 = 0; k0 < H; k0 += KS) {
          __syncthreads();  // r1 is free
          // W^T slab: row c - k0 for c in [k0, k0 + KS), column j
          for (int bidx = tid; bidx < NBJ * NBC; bidx += kThreads) {
            const int cb = bidx % NBC, jb = bidx / NBC;  // lanes walk along c
            float4 rows[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              rows[q] = __ldg(reinterpret_cast<const float4*>(
                  w + (jb * 4 + q) * H + k0 + cb * 4));
#pragma unroll
            for (int q = 0; q < 4; ++q) {   // W^T row k0 + cb*4 + q
              const float4 v = make_float4(lane(rows[0], q), lane(rows[1], q),
                                           lane(rows[2], q), lane(rows[3], q));
              float4 hv, lv;
              wsplit(v.x, gm, &hv.x, &lv.x);
              wsplit(v.y, gm, &hv.y, &lv.y);
              wsplit(v.z, gm, &hv.z, &lv.z);
              wsplit(v.w, gm, &hv.w, &lv.w);
              const int idx = (cb * 4 + q) * H + jb * 4;
              *reinterpret_cast<float4*>(th + idx) = hv;
              *reinterpret_cast<float4*>(tl + idx) = lv;
            }
          }
          __syncthreads();
          dense_dispatch<H>(gm, Xhi + k0, Xlo + k0, th, tl, r0, c0, c1, acc,
                            acc2, KS);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* rowp = r1 + (r0 + i) * LD;
          *reinterpret_cast<float4*>(rowp + c0) = make_float4(
              acc[i][0] + acc2[i][0], acc[i][1] + acc2[i][1],
              acc[i][2] + acc2[i][2], acc[i][3] + acc2[i][3]);
          *reinterpret_cast<float4*>(rowp + c1) = make_float4(
              acc[i][4] + acc2[i][4], acc[i][5] + acc2[i][5],
              acc[i][6] + acc2[i][6], acc[i][7] + acc2[i][7]);
        }
        __syncthreads();
      }
    }

    // ---- layer 0 dW: the grad-tier product of its input and gpre0 ----
    if (F > 0) {
      // dW0 = [cos v, sin v]^T gpre0, the features recomputed by K-slabs
      // into r1 on the rounded side
      const int K = 2 * F;
      for (int k0 = 0; k0 < K; k0 += KS) {
        const int kn = K - k0 < KS ? K - k0 : KS;
        const int kn4 = (kn + 3) & ~3;
        __syncthreads();
        for (int e = tid; e < TM * kn4; e += kThreads) {
          const int r = e / kn4, j = e % kn4;
          const float v = j < kn ? rff_feature(sc + r * d, args.bt, d, F,
                                               k0 + j, args.fdeg)
                                 : 0.0f;
          xsplit(v, gm, r1 + r * LD + j, r1 + TM * LD + r * LD + j);
        }
        __syncthreads();
        wgrad(kn4, kn, slab + args.off_w[0] + k0 * H, first);
      }
    } else {
      // coords^T gpre0, rows split over TPC
      __syncthreads();
      float acc[kMaxIn], acc2[kMaxIn];
#pragma unroll
      for (int q = 0; q < kMaxIn; ++q) acc[q] = acc2[q] = 0.0f;
      for (int r = es; r < TM; r += TPC) {
        const float gh = Xhi[r * LD + ec], gl = Xlo[r * LD + ec];
#pragma unroll
        for (int q = 0; q < kMaxIn; ++q) {
          if (q < d) {
            float xh, xl;
            xsplit(sc[r * d + q], gm, &xh, &xl);
            acc[q] = fmaf(xh, gh, acc[q]);
            if (gm == kBf16x2 || gm == kBf16x3) acc2[q] = fmaf(xh, gl, acc2[q]);
            if (gm == kBf16x3) acc2[q] = fmaf(xl, gh, acc2[q]);
          }
        }
      }
      float* part = r1;  // (TPC, d, H) x 2
      for (int q = 0; q < d; ++q) {
        part[(es * d + q) * H + ec] = acc[q];
        part[TPC * d * H + (es * d + q) * H + ec] = acc2[q];
      }
      __syncthreads();
      if (es == 0) {
        for (int q = 0; q < d; ++q) {
          float s1 = part[q * H + ec], s2 = part[TPC * d * H + q * H + ec];
          for (int grp = 1; grp < TPC; ++grp) {
            s1 += part[(grp * d + q) * H + ec];
            s2 += part[TPC * d * H + (grp * d + q) * H + ec];
          }
          put(slab + args.off_w[0] + q * H + ec, s1 + s2, first);
        }
      }
    }
  }
  if (tid == 0 && cot == nullptr) loss_part[blockIdx.x] = loss_acc;
}

// ===========================================================================
// The tensor-core route: every grad launch whose grad tier and forward tiers
// (layers 1+, and an RFF layer 0) are bf16, bf16x2 or bf16x3.  The highest
// tier is an exact f32 product, which no tensor-core pass gives: it keeps
// siren_grad_kernel above, as its own route.
//
// Three launches a pass, then the reduce:
// - siren_wsplit_kernel: each window's h x h weights (and an RFF W0) into
//   packed bf16 hi/lo planes, once per launch group (the w-role split), and
//   each h x h W transposed beside them, the dgrad's operand;
// - siren_sweep_kernel, per unit = (window, row slice), over the tiles of
//   one row chunk of its slice, Sw<H>::G row tiles at a time: the forward
//   recompute, the cotangent, the head (narrow FMAs), and the dgrad sweep,
//   with W streamed in slabs of packed bf16 planes through a ring of
//   shared-memory stages.  For each h x h layer it writes dW's operands
//   once, as bf16 planes, into the unit's scratch: x_in's hi (and lo in
//   bf16x3) and gpre's hi (and lo in bf16x2 / bf16x3); for an RFF model
//   gpre0's.  db, da, the head's dW and a raw layer 0's dW go to the unit's
//   slab as before (a slice's first tile stores, later tiles add, in tile
//   order: a few H floats a layer);
// - siren_dw_kernel, per (unit, output tile of a layer): dW = x_in^T gpre
//   (and the RFF dW0 = [cos; sin]^T gpre0, the features recomputed from the
//   coordinates) as one large-K tensor-core product over the chunk's rows
//   (mma.sync m16n8k16 on ldmatrix fragments), accumulated in registers in
//   a fixed order; each element is written once per chunk (the first chunk
//   stores, later chunks add, in chunk order).
// A unit's slab is thus written once per chunk instead of read and written
// back on every row tile.  Numerics: the x role rounded and the w role split
// as _kernel_dot does, hi.hi apart from the cross terms, summed at the end;
// a raw layer 0 exact f32; sin / cos and -fmad=false as above.  Where the
// products run:
// - dW, and an RFF layer 0's forward: every term on the tensor cores, a
//   pass per term; each step's hi.hi in a fresh accumulator, added in f32;
// - the dgrad: the cross term on the tensor cores (mma.sync m16n8k16, k16
//   blocks in order, each in a fresh accumulator added in f32), hi.hi as
//   fp32 FMAs in k order (the plain version's own order);
// - the forward of layers 1+: every term as fp32 FMAs, in the FMA kernel's
//   chains, so its pres are that kernel's bit for bit: for each output,
//   hh = sum_k xh wh and cr = sum_k (xh wl, then xl wh in bf16x3), k
//   ascending, then pre = (hh + cr) + b.
// Why not everything on the tensor cores: the tensor core sums 16 products
// at a time (with truncation), and an ulp of difference in a pre is
// multiplied by omega in the next sine and flips the bf16 rounding of later
// operands.  On an H100 an all-mma sweep was faster but moved C's bf16x3
// gradients past the card tests' f32 bound (2e-6 of the largest) and D's
// bf16x2 state past its bulk bound; with only hi.hi in the reference's
// order the card tests passed, but the headline encode's 300-step fit left
// the plain-step fit by more than chip_smoke's 1 dB of median per-hop SNR.
// With the whole forward in the FMA kernel's order every gate passes.
//
// What bounds the sweep, then, is the issue rate of those fp32 FMAs (about
// 1.05M a row at h = 256: the forward's three terms and the dgrad's hi.hi
// of four h x h layers), not the tensor cores.  Its design (Sw<H>) keeps
// the FMA pipes fed:
// - G row tiles a CTA at once (R = G TM rows: 64 at h = 256, 128 at h =
//   128; G = 1 at h = 32 and 64, whose tiles are 256 and 128 rows already
//   and whose slices are often one tile), so each W slab in shared memory
//   serves R rows;
// - a register tile of 8 rows x TC columns a thread (8 x 8 at G = 2, 8 x 4
//   at G = 1), every output's hh and cr chains in registers; the operand
//   planes are k-major (a layer's input and gpre as [k][row], the slabs as
//   [k][column]), so each k's 8 rows are one 16-byte shared load a plane,
//   its TC columns another, converted to f32 by one shift or mask a value
//   and loaded a k ahead of the FMAs that use them;
// - W slabs of 16 rows through a ring of NST stages (4 at h = 256, 8
//   below), each plane of a slab one bulk copy (cp.async.bulk) issued by
//   the warps in turn and completed on an mbarrier: the weight planes'
//   rows are swizzled (swz_off) so that a dense slab serves ldmatrix and the
//   FMA tile without bank conflicts.  A warp waits only for the slab it needs,
//   never on a barrier of the whole CTA, and releases it by its own
//   arrival; the next product's first slabs load while a layer's
//   elementwise phase runs;
// - the elementwise phases (a layer's activation and its split, gpre) as
//   column passes with the layer's activation a compile-time choice
//   (with_act): one straight-line copy of it, runs of 8 rows a thread, the
//   k-major planes written 16 bytes at a time; a product's sums reach them
//   through dX;
// - the per-tile sums (the loss, the head's db and da) in parallel, a warp
//   a tile, each in its own order.
// Every output keeps the chain above, and every sum over rows its one-tile
// grouping and order, so the results are those of the one-tile design bit
// for bit.
// Determinism: no float atomics; the slices and chunks are functions of the
// shapes (ops/siren_train.py: tc_plan), so the grouping of windows and
// units into passes leaves every result bit-equal.
// ===========================================================================

template <int H>
struct Sw {
  static constexpr int TM = tile_rows<H>();
  static constexpr int G = H >= 128 ? 2 : 1;   // row tiles a CTA carries
  static constexpr int R = G * TM;             // rows a group
  static constexpr int RP = R + 8;             // X / G plane pitch (bf16)
  static constexpr int LDX = H + 4;            // dX pitch (f32)
  static constexpr int KS = 16;                // W slab rows
  static constexpr int SLAB = KS * H;          // one plane of a slab (bf16)
  static constexpr int NST = H == 256 ? 4 : 8; // ring stages
  static constexpr int TC = 4 * G;             // FMA tile: 8 rows x TC cols
  static constexpr int WCF = H / TC / 8;       // FMA tile: warps along cols
  static constexpr int WN = H / 32;            // mma: warps along the columns
  static constexpr int MT = 2 * G;             // mma: m16 tiles a warp
  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(2 * NST) * 8            // mbarriers
           + static_cast<size_t>(2 * H * RP) * 2       // X / G planes
           + static_cast<size_t>(NST * 2 * SLAB) * 2   // W ring
           + static_cast<size_t>(R * LDX) * 4          // dX
           + static_cast<size_t>(2 * H + R * kMaxIn + 5 * R +
                                 2 * G * kThreads + 4 * G) * 4;
  }
};

static_assert(Sw<32>::smem_bytes() <= 232448, "sweep smem h=32");
static_assert(Sw<64>::smem_bytes() <= 232448, "sweep smem h=64");
static_assert(Sw<128>::smem_bytes() <= 232448, "sweep smem h=128");
static_assert(Sw<256>::smem_bytes() <= 232448, "sweep smem h=256");
static_assert(Sw<32>::R * 32 == 8 * kThreads * Sw<32>::TC &&
              Sw<256>::R * 256 == 8 * kThreads * Sw<256>::TC,
              "one 8 x TC tile a thread covers the group");

// bf16 weight planes a window on the tensor-core route: the h x h layers'
// W, an RFF W0 (2F x h), then each h x h W transposed (the dgrad's slabs).
__host__ __device__ inline long long tc_wq(int n_layers, int h, int n_freq) {
  return 2LL * (n_layers - 2) * h * h + 2LL * n_freq * h;
}

// The weight planes' rows are swizzled (siren_wsplit_kernel writes them
// so, and the sweep's slabs copy them as they are): the 16-byte chunk c of
// row k sits at chunk c ^ swz(h, k), so that ldmatrix's 8 rows at one chunk
// fall in 8 distinct banks of a dense slab.
__host__ __device__ inline int swz(int h, int k) {
  return h >= 64 ? (k & 7) : ((k >> 1) & 3);  // h = 32: 4 chunks a row
}

// Offset of element (k, c) in a swizzled plane of rows of h.
__host__ __device__ inline int swz_off(int h, int k, int c) {
  return k * h + (((c >> 3) ^ swz(h, k)) << 3) + (c & 7);
}

// Planes of a unit's scratch: for each h x h layer x_in hi, [x_in lo in
// bf16x3], gpre hi, [gpre lo in bf16x2 / bf16x3], each (rows_cap x H); then
// an RFF model's gpre0 hi, [lo].  ops/siren_train.py: tc_unit_planes.
__host__ __device__ inline int tc_x_planes(int gm) { return gm == kBf16x3 ? 2 : 1; }
__host__ __device__ inline int tc_g_planes(int gm) { return gm == kBf16 ? 1 : 2; }

// --- mbarriers and bulk copies (the sweep's W ring) ---

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
}

// whether the phase of `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) global -> shared by the copy engine; their
// arrival counts against `bar`'s expected transaction bytes
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The W slabs of one unit's sweep, in the order its products read them:
// per group of row tiles an RFF W0's slabs (if any), the forward's h x h
// layers 1 .. L-2, then the dgrad's L-2 .. 1 (rows of W^T).  Slab j is
// issued by warp j % 8, up to NST - 1 slabs ahead of the slab the warp
// consumes next, once every warp has released its stage; a warp waits for
// that only for a slab of its own that it is about to read.  The slowest
// warp has released every stage before the slab it reads, so every slab
// it waits for gets issued.
template <int H>
struct SlabRing {
  using S = Sw<H>;
  static constexpr int LS = H / S::KS;  // slabs an h x h layer
  bf16* stage;                          // NST x [hi, lo] slabs
  unsigned long long* full;             // NST: a slab has landed
  unsigned long long* empty;            // NST: every warp has read it
  const bf16* wh;                       // the window's weight planes
  const bf16* wl;
  int nh;     // h x h layers
  int K0;     // an RFF W0's rows (2F), or 0
  int nsi;    // slabs a group
  int total;  // slabs of the launch
  int q;      // the next slab to consume
  int next;   // the next slab this warp issues (its own: j % 8 == warp)

  __device__ void init(bf16* st, unsigned long long* bars, const bf16* h,
                       const bf16* l, int layers, int k0rows, int groups) {
    stage = st;
    full = bars;
    empty = bars + S::NST;
    wh = h;
    wl = l;
    nh = layers;
    K0 = k0rows;
    nsi = (K0 + S::KS - 1) / S::KS + 2 * nh * LS;
    total = groups * nsi;
    q = 0;
    next = threadIdx.x / 32;
  }

  // the warp: slab `next` into its stage
  __device__ void issue() {
    constexpr int KS = S::KS;
    const int lane = threadIdx.x & 31;
    const int s = next % S::NST;
    if (next >= S::NST)  // the stage's previous slab, released by all
      mbar_wait(&empty[s], ((next / S::NST) - 1) & 1);
    const long long HH = static_cast<long long>(H) * H;
    const int nr = (K0 + KS - 1) / KS;
    int j = next % nsi, K = H, k0;
    long long off;
    if (j < nr) {  // an RFF W0
      off = nh * HH;
      K = K0;
      k0 = j * KS;
    } else if ((j -= nr) < nh * LS) {  // the forward's W, layers 1 ..
      off = (j / LS) * HH;
      k0 = (j % LS) * KS;
    } else {  // the dgrad's W^T, layers L-2 .. 1
      j -= nh * LS;
      off = nh * HH + static_cast<long long>(K0) * H +
            (nh - 1 - j / LS) * HH;
      k0 = (j % LS) * KS;
    }
    const int kn = K - k0 < KS ? K - k0 : KS;
    bf16* dh = stage + s * 2 * S::SLAB;
    bf16* dl = dh + S::SLAB;
    if (kn < KS) {  // a ragged W0: zero its rows up to the next k16 block
      const int kz = (kn + 15) & ~15;
      for (int e = kn * H / 8 + lane; e < kz * H / 8; e += 32) {
        reinterpret_cast<uint4*>(dh)[e] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(dl)[e] = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) {  // the slab's rows are contiguous: one copy a plane
      const long long src = off + static_cast<long long>(k0) * H;
      mbar_expect_tx(&full[s], 2u * kn * H * 2);
      bulk_g2s(dh, wh + src, kn * H * 2, &full[s]);
      bulk_g2s(dl, wl + src, kn * H * 2, &full[s]);
    }
    next += kThreads / 32;
  }

  // every thread: the next slab's stage, once it has landed
  __device__ const bf16* acquire() {
    const int lim = q + S::NST < total ? q + S::NST : total;
    while (next < lim) {
      // a later slab whose stage some warp still reads waits for the
      // warp's next acquire (lane 0 decides for the warp)
      bool busy = false;
      if (next > q && next >= S::NST && (threadIdx.x & 31) == 0)
        busy = !mbar_test(&empty[next % S::NST], ((next / S::NST) - 1) & 1);
      if (__shfl_sync(0xffffffffu, busy, 0)) break;
      issue();
    }
    const int s = q % S::NST;
    mbar_wait(&full[s], (q / S::NST) & 1);
    return stage + s * 2 * S::SLAB;
  }

  // every thread, after its last read of the slab
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[q % S::NST]);
    ++q;
  }
};

// N packed bf16 (one 16- or 8-byte shared load) and their f32 values
template <int N>
struct Packed {
  unsigned v[N / 2];
};

template <int N>
__device__ __forceinline__ Packed<N> ld_packed(const bf16* p) {
  Packed<N> r;
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r.v[0] = u.x;
    r.v[1] = u.y;
    r.v[2] = u.z;
    r.v[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.v[0] = u.x;
    r.v[1] = u.y;
  }
  return r;
}

template <int N>
__device__ __forceinline__ void unpack(const Packed<N>& r, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    f[2 * i] = __uint_as_float(r.v[i] << 16);
    f[2 * i + 1] = __uint_as_float(r.v[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack2(bf16 a, bf16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// hh and cr += one W slab (KS values of k, in order) as fp32 FMAs for the
// thread's 8 x TC outputs: ah / al point at the A planes' first k of the
// slab and the thread's 8 rows (k-major, pitch RP), bh / bl at the slab's
// planes (swizzled rows of H), whose columns col0 .. col0 + TC are the
// thread's.  MODE: the forward's tier,
// every term in the FMA kernel's chains (dense_tile: hi.hi into hh; hi.lo,
// then lo.hi in bf16x3, into cr at each k); kBf16 for the dgrad's hi.hi.
// The products of bf16 values are exact, so every FMA rounds as the
// reference's does.
template <int H, int MODE>
__device__ __forceinline__ void fma_slab(const bf16* ah, const bf16* al,
                                         const bf16* bh, const bf16* bl,
                                         int col0, float (&hh)[8][Sw<H>::TC],
                                         float (&cr)[8][Sw<H>::TC]) {
  using S = Sw<H>;
  constexpr int TC = S::TC, KS = S::KS, RP = S::RP;
  constexpr bool XL = MODE == kBf16x3, WL = MODE != kBf16;
  Packed<8> xa = ld_packed<8>(ah), xb{};
  Packed<TC> wa = ld_packed<TC>(bh + swz_off(H, 0, col0)), wb{};
  if (XL) xb = ld_packed<8>(al);
  if (WL) wb = ld_packed<TC>(bl + swz_off(H, 0, col0));
#pragma unroll 4
  for (int k = 0; k < KS; ++k) {
    const int kn = k + 1 < KS ? k + 1 : k;  // the next k's operands
    const int wo = swz_off(H, kn, col0);
    const Packed<8> na = ld_packed<8>(ah + kn * RP);
    const Packed<TC> nw = ld_packed<TC>(bh + wo);
    Packed<8> nb{};
    Packed<TC> nl{};
    if (XL) nb = ld_packed<8>(al + kn * RP);
    if (WL) nl = ld_packed<TC>(bl + wo);
    float xh[8], xl[8], wh[TC], wl[TC];
    unpack(xa, xh);
    unpack(wa, wh);
    if (XL) unpack(xb, xl);
    if (WL) unpack(wb, wl);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        hh[i][c] = fmaf(xh[i], wh[c], hh[i][c]);
        if (WL) cr[i][c] = fmaf(xh[i], wl[c], cr[i][c]);
        if (XL) cr[i][c] = fmaf(xl[i], wh[c], cr[i][c]);
      }
    xa = na;
    wa = nw;
    xb = nb;
    wb = nl;
  }
}

// One slab's product on the tensor cores for the warp's (32 G) x 32 block
// of the (R x H) output: A's k-major planes (pitch RP) from k-row ka, read
// with ldmatrix .trans; B the slab ([k][column], swizzled rows of H), read
// with .trans.  With HH every term of the tier (hi.hi into hh, the cross terms
// into cr), else the cross terms alone, each k16 step's sums in fresh
// accumulators added in f32 (tier_mma_f32, cross_mma).
template <int H, int MODE, bool HH>
__device__ __forceinline__ void mma_slab(const bf16* Ah, const bf16* Al,
                                         int ka, const bf16* Bh,
                                         const bf16* Bl, int ksteps,
                                         float (&hh)[Sw<H>::MT][4][4],
                                         float (&cr)[Sw<H>::MT][4][4]) {
  using S = Sw<H>;
  constexpr int MT = S::MT, RP = S::RP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp / S::WN) * 16 * MT, n0 = (warp % S::WN) * 32;
#pragma unroll 1
  for (int s = 0; s < ksteps; ++s) {
    const int kk = s * 16;
    unsigned ah[MT][4], al[MT][4] = {};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int off = (ka + kk + (lane & 7) + ((lane >> 4) & 1) * 8) * RP +
                      m0 + mi * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(ah[mi], Ah + off);
      if (MODE == kBf16x3) ldsm_x4_t(al[mi], Al + off);
    }
#pragma unroll
    for (int nj = 0; nj < 4; nj += 2) {
      unsigned bh[4], bl[4] = {};
      const int off = swz_off(H, kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                              n0 + nj * 8 + (lane >> 4) * 8);
      ldsm_x4_t(bh, Bh + off);
      if (MODE != kBf16) ldsm_x4_t(bl, Bl + off);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (HH) {
          tier_mma_f32<MODE>(hh[mi][nj], cr[mi][nj], ah[mi], al[mi], bh[0],
                             bh[1], bl[0], bl[1]);
          tier_mma_f32<MODE>(hh[mi][nj + 1], cr[mi][nj + 1], ah[mi], al[mi],
                             bh[2], bh[3], bl[2], bl[3]);
        } else {
          cross_mma<MODE>(cr[mi][nj], ah[mi], al[mi], bh[0], bh[1], bl[0],
                          bl[1]);
          cross_mma<MODE>(cr[mi][nj + 1], ah[mi], al[mi], bh[2], bh[3],
                          bl[2], bl[3]);
        }
      }
    }
  }
}

// The forward product of an h x h layer, (R x H) x (H x H), every term as
// FMAs in the tier MODE, W's slabs from the ring: the thread's 8 x TC
// outputs from row0, col0 into hh, cr.
template <int H, int MODE>
__device__ __forceinline__ void fwd_product(SlabRing<H>& ring,
                                            const bf16* Xh, const bf16* Xl,
                                            int row0, int col0,
                                            float (&hh)[8][Sw<H>::TC],
                                            float (&cr)[8][Sw<H>::TC]) {
  using S = Sw<H>;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < S::TC; ++c) hh[i][c] = cr[i][c] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < H / S::KS; ++s) {
    const bf16* st = ring.acquire();
    const int a = s * S::KS * S::RP + row0;
    fma_slab<H, MODE>(Xh + a, Xl + a, st, st + S::SLAB, col0, hh, cr);
    ring.release();
  }
}

// The dgrad of an h x h layer, gpre (R x H) W^T, the slabs being W^T's
// rows: hi.hi as FMAs into the thread's 8 x TC tile (hh), the cross terms
// of the grad tier GM on the tensor cores into the warp's block (cr).
template <int H, int GM>
__device__ __forceinline__ void dgrad_product(SlabRing<H>& ring,
                                              const bf16* Gh, const bf16* Gl,
                                              int row0, int col0,
                                              float (&hh)[8][Sw<H>::TC],
                                              float (&cr)[Sw<H>::MT][4][4]) {
  using S = Sw<H>;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < S::TC; ++c) hh[i][c] = 0.0f;
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) cr[mi][nj][q] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < H / S::KS; ++s) {
    const bf16* st = ring.acquire();
    const bf16* a = Gh + s * S::KS * S::RP + row0;
    fma_slab<H, kBf16>(a, a, st, st, col0, hh, hh);
    if (GM != kBf16)
      mma_slab<H, GM, false>(Gh, Gl, s * S::KS, st, st + S::SLAB,
                             S::KS / 16, cr, cr);
    ring.release();
  }
}

// A layer's activation with its kind and sin / cos degree as constants, so
// that an elementwise loop carries one straight-line copy of it (the
// values are those of activate and dact with the same arguments).
template <int KIND, int DEG>
struct Act {
  __device__ __forceinline__ float operator()(float pre, float omega,
                                              float a) const {
    return activate(KIND, pre, omega, a, DEG);
  }
  __device__ __forceinline__ float grad(float pre, float omega, float a,
                                        float g, float* ga) const {
    return dact(KIND, pre, omega, a, DEG, g, ga);
  }
};

// f(Act<kind, deg>{}) for a layer's runtime kind and degree (trig_sin and
// trig_cos take any degree other than 0, 7 and 9 as 11).
template <typename F>
__device__ __forceinline__ void with_act(int kind, int deg, F&& f) {
  if (kind == kSine || kind == kSnake) {
    const bool sine = kind == kSine;
    if (deg == 0)
      sine ? f(Act<kSine, 0>{}) : f(Act<kSnake, 0>{});
    else if (deg == 7)
      sine ? f(Act<kSine, 7>{}) : f(Act<kSnake, 7>{});
    else if (deg == 9)
      sine ? f(Act<kSine, 9>{}) : f(Act<kSnake, 9>{});
    else
      sine ? f(Act<kSine, 11>{}) : f(Act<kSnake, 11>{});
  } else if (kind == kTanh) {
    f(Act<kTanh, 0>{});
  } else {
    f(Act<kLinear, 0>{});
  }
}

// The thread's FMA tile of sums s = hh + cr into dX (R x H f32, pitch
// LDX), for store_cols.
template <int H>
__device__ __forceinline__ void stage_tile(const float (&hh)[8][Sw<H>::TC],
                                           const float (&cr)[8][Sw<H>::TC],
                                           float* dX, int row0, int col0) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < Sw<H>::TC; c += 4)
      *reinterpret_cast<float4*>(dX + (row0 + i) * Sw<H>::LDX + col0 + c) =
          make_float4(hh[i][c] + cr[i][c], hh[i][c + 1] + cr[i][c + 1],
                      hh[i][c + 2] + cr[i][c + 2], hh[i][c + 3] + cr[i][c + 3]);
}

// The warp's mma block of sums s = hh + cr into dX, for store_cols.
template <int H>
__device__ __forceinline__ void stage_frag(const float (&hh)[Sw<H>::MT][4][4],
                                           const float (&cr)[Sw<H>::MT][4][4],
                                           float* dX) {
  using S = Sw<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp / S::WN) * 16 * S::MT, n0 = (warp % S::WN) * 32;
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mi * 16 + (lane >> 2) + half * 8;
        const int col = n0 + nj * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dX + row * S::LDX + col) = make_float2(
            hh[mi][nj][half * 2] + cr[mi][nj][half * 2],
            hh[mi][nj][half * 2 + 1] + cr[mi][nj][half * 2 + 1]);
      }
}

// A layer's output from its sums s = hh + cr, staged in dX (R x H f32,
// pitch LDX): pre = s + b saved to pre_out (R x H f32), and the activation
// (0 at or past `live`) split into the X planes (k-major) and, as the next
// layer's x_in for dW, into xg (rows of H: hi, and lo at xg + xlo when
// xlo > 0) for the rows below rows_ok.  A column a thread, runs of 8
// rows: the X planes take one 16-byte store a plane and run.
template <int H, typename A>
__device__ __forceinline__ void store_cols(A act, const float* dX,
                                           const float* sb, const float* sa,
                                           float omega, bf16* Xh, bf16* Xl,
                                           float* pre_out, int live, bf16* xg,
                                           long long xlo, int rows_ok) {
  using S = Sw<H>;
  constexpr int TPC = kThreads / H, RB = S::R / TPC;
  const int ec = threadIdx.x % H, es = threadIdx.x / H;
  const float b = sb[ec], a = sa[ec];
  const bool on = ec < live;
#pragma unroll 1
  for (int r0 = es * RB; r0 < (es + 1) * RB; r0 += 8) {
    bf16 hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      const float p = dX[r * S::LDX + ec] + b;
      pre_out[r * H + ec] = p;
      split_bf16(on ? act(p, omega, a) : 0.0f, &hi[i], &lo[i]);
      if (xg != nullptr && r < rows_ok) {
        xg[r * H + ec] = hi[i];
        if (xlo > 0) xg[xlo + r * H + ec] = lo[i];
      }
    }
    const int o = ec * S::RP + r0;
    *reinterpret_cast<uint4*>(Xh + o) =
        make_uint4(pack2(hi[0], hi[1]), pack2(hi[2], hi[3]),
                   pack2(hi[4], hi[5]), pack2(hi[6], hi[7]));
    *reinterpret_cast<uint4*>(Xl + o) =
        make_uint4(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]),
                   pack2(lo[4], lo[5]), pack2(lo[6], lo[7]));
  }
}

// Each window's weights split into packed bf16 hi / lo planes, (k, wq)
// each (tc_wq): the h x h layers 1 .. L-2, an RFF W0 (2F x h), then the h x
// h layers' W transposed, every row swizzled (swz_off).  The w role of
// every tensor-core product of the step.
__global__ void __launch_bounds__(kThreads)
siren_wsplit_kernel(const float* __restrict__ params, bf16* __restrict__ whi,
                    bf16* __restrict__ wlo, const TrainArgs args, int h,
                    long long wq, int k) {
  const long long hh = static_cast<long long>(h) * h;
  const long long nhh = (args.n_layers - 2) * hh;
  const long long w0 = nhh + 2LL * args.n_freq * h;  // W^T from here
  const long long total = wq * k;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long w = e / wq, i = e % wq;
    // the plane's row k and the logical column of swizzled position cp
    const long long t = i < nhh ? i % hh : i < w0 ? i - nhh : (i - w0) % hh;
    const int k = static_cast<int>(t / h), cp = static_cast<int>(t % h);
    const int c = (((cp >> 3) ^ swz(h, k)) << 3) + (cp & 7);
    long long src;
    if (i < nhh)
      src = args.off_w[1 + i / hh] + static_cast<long long>(k) * h + c;
    else if (i < w0)
      src = args.off_w[0] + static_cast<long long>(k) * h + c;
    else  // W^T[k][c] = W[c][k]
      src = args.off_w[1 + (i - w0) / hh] + static_cast<long long>(c) * h + k;
    split_bf16(params[w * args.P + src], whi + e, wlo + e);
  }
}

// One unit (window, row slice) over the row tiles of chunk `chunk` of its
// slice, G tiles at a time (the last group of a chunk may hold fewer):
// forward recompute, cotangent, head, dgrad sweep; dW's operands into the
// unit's planes (local row = row - the chunk's first row).
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_sweep_kernel(const float* __restrict__ coords,
                   const float* __restrict__ params,
                   const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
                   float* __restrict__ partial, float* __restrict__ loss_part,
                   float* __restrict__ pre_buf, bf16* __restrict__ planes,
                   const float* __restrict__ tgt,
                   const float* __restrict__ cot,
                   const int* __restrict__ limit, const TrainArgs args,
                   int n, int tiles, int slices, int u0, int chunk,
                   int chunk_tiles, int rows_cap, long long unit_elems,
                   long long wq) {
  using S = Sw<H>;
  constexpr int TM = S::TM, G = S::G, R = S::R, RP = S::RP, LDX = S::LDX;
  constexpr int KS = S::KS, TC = S::TC, MT = S::MT, NST = S::NST;
  constexpr int TPR = kThreads / TM;   // head forward: threads per row
  constexpr int TPC = kThreads / H;    // column passes: threads per column
  constexpr int RPT = TM / TPC;        // column passes: a tile's rows a thread
  static_assert(RPT % 8 == 0, "rows per thread in chunks of 8");
  extern __shared__ float4 smem4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);
  bf16* Xh = reinterpret_cast<bf16*>(bars + 2 * NST);  // X, then G planes
  bf16* Xl = Xh + H * RP;
  bf16* ring_st = Xl + H * RP;                         // [stage][hi, lo]
  float* dX = reinterpret_cast<float*>(ring_st + NST * 2 * S::SLAB);
  float* sb = dX + R * LDX;
  float* sa = sb + H;
  float* sc = sa + H;
  float* shp = sc + R * kMaxIn;        // head pre
  float* shg = shp + R;                // head gpre (f32)
  float* shh = shg + R;                // head gpre hi
  float* shl = shh + R;                // head gpre lo
  float* sl = shl + R;                 // per-row loss
  float* red = sl + R;                 // G x 2 x kThreads column partials
  float* tsum = red + 2 * G * kThreads;  // per tile: loss, db, da

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = u0 + blockIdx.x;
  const long long win = u / slices;
  const int slice = u % slices;
  const int t_begin = static_cast<int>(static_cast<long long>(slice) * tiles /
                                       slices);
  const int t_end = static_cast<int>(static_cast<long long>(slice + 1) *
                                     tiles / slices);
  const int c0t = t_begin + chunk * chunk_tiles;
  if (c0t >= t_end) return;
  const int c1t = min(t_end, c0t + chunk_tiles);
  const int d = args.d;
  const int L = args.n_layers;
  const int LH = L - 1;
  const int gm = args.gmode;
  const int F = args.n_freq;
  const float* wp = params + win * args.P;
  float* slab = partial + static_cast<long long>(u) * args.P;
  float* pre_tile =
      pre_buf + static_cast<long long>(blockIdx.x) * L * (R * H);
  bf16* up = planes + blockIdx.x * unit_elems;
  const long long RCH = static_cast<long long>(rows_cap) * H;
  const int npl = tc_x_planes(gm) + tc_g_planes(gm);
  const long long xlo = gm == kBf16x3 ? RCH : 0;  // x_in's lo plane
  const int ec = tid % H, es = tid / H;  // column-pass mapping
  const int n_lim = limit != nullptr ? min(n, __ldg(limit)) : n;
  // the thread's FMA tile: a warp's lanes are 4 row groups x 8 column groups
  const int row0 = ((warp / S::WCF) * 4 + lane / 8) * 8;
  const int col0 = ((warp % S::WCF) * 8 + lane % 8) * TC;

  SlabRing<H> ring;
  ring.init(ring_st, bars, whi + win * wq, wlo + win * wq, L - 2, 2 * F,
            (c1t - c0t + G - 1) / G);
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (chunk == 0) {  // zero the pads between leaves of the slab
      for (int li = 0; li < L; ++li) {
        const int in_f = li == 0 ? (F > 0 ? 2 * F : d) : H;
        const int out_f = li == L - 1 ? 1 : H;
        int ends[3] = {args.off_w[li] + in_f * out_f, args.off_b[li] + out_f,
                       args.off_a[li] >= 0 ? args.off_a[li] + out_f : -1};
        for (int q = 0; q < 3; ++q)
          for (int e = ends[q]; e >= 0 && (e & 3); ++e) slab[e] = 0.0f;
      }
    }
  }
  float loss_acc = 0.0f;  // thread 0: the chunk's loss

  for (int t = c0t; t < c1t; t += G) {
    const int ng = min(G, c1t - t);      // tiles in this group
    const int rows_ok = ng * TM;         // its rows of real tiles
    const int row_g0 = t * TM;
    const long long lr0 = static_cast<long long>(t - c0t) * TM;
    __syncthreads();  // the previous group is done with shared memory

    // ================= forward recompute, saving each pre =================
    {
      for (int e = tid; e < H; e += kThreads) {
        sb[e] = wp[args.off_b[0] + e];
        sa[e] = args.off_a[0] >= 0 ? wp[args.off_a[0] + e] : 1.0f;
      }
      for (int e = tid; e < R * d; e += kThreads) {
        const int r = e / d, row = row_g0 + r;
        sc[e] = r < rows_ok && row < n ? coords[(long long)row * d + e % d]
                                       : 0.0f;
      }
      const int kind = args.kind[0], deg = args.deg[0];
      const float omega = args.omega[0];
      // x_in of layer 1, for dW (none when layer 1 is the head)
      bf16* xg0 = L > 2 ? up + lr0 * H : nullptr;
      if (F > 0) {
        // [cos v, sin v] W0 by slabs: the features of the slab into the X
        // planes (the forward tier's split), W0's slab from the ring
        const int K = 2 * F;
        float hf[MT][4][4], cf[MT][4][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int q = 0; q < 4; ++q) hf[mi][nj][q] = cf[mi][nj][q] = 0.0f;
        for (int k0 = 0; k0 < K; k0 += KS) {
          const int kn = K - k0 < KS ? K - k0 : KS;
          const int kz = (kn + 15) & ~15;
          __syncthreads();  // the previous slab's features are consumed
          for (int e = tid; e < R * kz; e += kThreads) {
            const int j = e / R, r = e % R;
            const float v = j < kn ? rff_feature(sc + r * d, args.bt, d, F,
                                                 k0 + j, args.fdeg)
                                   : 0.0f;
            split_bf16(v, Xh + j * RP + r, Xl + j * RP + r);
          }
          __syncthreads();
          const bf16* st = ring.acquire();
          const bf16* sl0 = st + S::SLAB;
          if (args.mode[0] == kBf16x3)
            mma_slab<H, kBf16x3, true>(Xh, Xl, 0, st, sl0, kz / 16, hf, cf);
          else if (args.mode[0] == kBf16x2)
            mma_slab<H, kBf16x2, true>(Xh, Xl, 0, st, sl0, kz / 16, hf, cf);
          else
            mma_slab<H, kBf16, true>(Xh, Xl, 0, st, sl0, kz / 16, hf, cf);
          ring.release();
        }
        stage_frag<H>(hf, cf, dX);
        __syncthreads();  // every warp has read the features
        with_act(kind, deg, [&](auto act) {
          store_cols<H>(act, dX, sb, sa, omega, Xh, Xl, pre_tile, args.h_real,
                        xg0, xlo, rows_ok);
        });
      } else {
        // exact f32 multiply-adds, a column a thread in runs of 8 rows
        const float* w0 = wp + args.off_w[0];
        float w[kMaxIn];
#pragma unroll
        for (int q = 0; q < kMaxIn; ++q) w[q] = q < d ? w0[q * H + ec] : 0.0f;
        __syncthreads();  // the coordinates are in
        with_act(kind, deg, [&](auto act) {
          constexpr int RB = R / TPC;
          const float b = sb[ec], a = sa[ec];
          const bool on = ec < args.h_real;
#pragma unroll 1
          for (int r0 = es * RB; r0 < (es + 1) * RB; r0 += 8) {
            bf16 hi[8], lo[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = r0 + i;
              float pre = b;
#pragma unroll
              for (int q = 0; q < kMaxIn; ++q)
                if (q < d) pre = pre + sc[r * d + q] * w[q];
              pre_tile[r * H + ec] = pre;
              split_bf16(on ? act(pre, omega, a) : 0.0f, &hi[i], &lo[i]);
              if (xg0 != nullptr && r < rows_ok) {
                xg0[r * H + ec] = hi[i];
                if (xlo > 0) xg0[xlo + r * H + ec] = lo[i];
              }
            }
            *reinterpret_cast<uint4*>(Xh + ec * RP + r0) = make_uint4(
                pack2(hi[0], hi[1]), pack2(hi[2], hi[3]), pack2(hi[4], hi[5]),
                pack2(hi[6], hi[7]));
            *reinterpret_cast<uint4*>(Xl + ec * RP + r0) = make_uint4(
                pack2(lo[0], lo[1]), pack2(lo[2], lo[3]), pack2(lo[4], lo[5]),
                pack2(lo[6], lo[7]));
          }
        });
      }
    }
    for (int li = 1; li < L - 1; ++li) {
      float hh[8][TC], cr[8][TC];
      float nb = 0.0f, na = 1.0f;  // layer li's bias and a, loaded early
      if (tid < H) {
        nb = wp[args.off_b[li] + tid];
        if (args.off_a[li] >= 0) na = wp[args.off_a[li] + tid];
      }
      __syncthreads();  // the X planes are complete
      if (args.mode[li] == kBf16x3)
        fwd_product<H, kBf16x3>(ring, Xh, Xl, row0, col0, hh, cr);
      else if (args.mode[li] == kBf16x2)
        fwd_product<H, kBf16x2>(ring, Xh, Xl, row0, col0, hh, cr);
      else
        fwd_product<H, kBf16>(ring, Xh, Xl, row0, col0, hh, cr);
      stage_tile<H>(hh, cr, dX, row0, col0);
      if (tid < H) {  // the bias of layer li - 1 was last read before X's
        sb[tid] = nb;
        sa[tid] = na;
      }
      __syncthreads();  // every warp has read X and staged its sums
      bf16* xg = li + 1 < L - 1 ? up + li * npl * RCH + lr0 * H : nullptr;
      with_act(args.kind[li], args.deg[li], [&](auto act) {
        store_cols<H>(act, dX, sb, sa, args.omega[li], Xh, Xl,
                      pre_tile + li * (R * H), args.h_real, xg, xlo, rows_ok);
      });
    }
    // head: h -> 1 (narrow FMAs), then the cotangent
    {
      const int mode = args.mode[LH];
      __syncthreads();
      for (int j = tid; j < H; j += kThreads) {
        const float w = wp[args.off_w[LH] + j];
        const float hi = bf16r(w);
        dX[j] = hi;
        dX[H + j] = bf16r(w - hi);
      }
      __syncthreads();
      const int s = tid % TPR;
#pragma unroll 1
      for (int g = 0; g < G; ++g) {
        const int r = g * TM + tid / TPR;
        float acc = 0.0f, acc2 = 0.0f;
        for (int j = s; j < H; j += TPR) {
          const float xv = __bfloat162float(Xh[j * RP + r]);
          acc = fmaf(xv, dX[j], acc);
          if (mode == kBf16x2 || mode == kBf16x3) acc2 = fmaf(xv, dX[H + j], acc2);
          if (mode == kBf16x3)
            acc2 = fmaf(__bfloat162float(Xl[j * RP + r]), dX[j], acc2);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off /= 2) {
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
          acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
        }
        if (s == 0) {
          const int row = row_g0 + r;
          const float pre = (acc + acc2) + wp[args.off_b[LH]];
          float gv = 0.0f, l = 0.0f;
          if (g < ng && row < n_lim) {
            const float a = args.off_a[LH] >= 0 ? wp[args.off_a[LH]] : 1.0f;
            const float out = activate(args.kind[LH], pre, args.omega[LH], a,
                                       args.deg[LH]);
            if (cot != nullptr) {
              gv = cot[win * n + row];
            } else {
              // the plain version's order: (err err) w and err (w 2/n); no
              // weight is w = 1, which gives the unweighted bits
              const float err = out - tgt[win * n + row];
              const float w = args.wgt != nullptr ? args.wgt[win * n + row]
                                                  : 1.0f;
              l = err * err * w;
              gv = err * (w * args.two_inv_n);
            }
          }
          shp[r] = pre;
          shg[r] = gv;
          sl[r] = l;
        }
      }
    }
    __syncthreads();

    // ================= backward =================
    // head: gpre, db, dW (h x 1) from the X planes (the head's input, the
    // grad tier's rounding: hi, and lo in bf16x3), and dX (R x h)
    {
      const int kind = args.kind[LH];
      const float a = args.off_a[LH] >= 0 ? wp[args.off_a[LH]] : 1.0f;
      for (int r = tid; r < R; r += kThreads) {
        float ga = 0.0f;
        const float gp = dact(kind, shp[r], args.omega[LH], a, args.deg[LH],
                              shg[r], &ga);
        shg[r] = gp;
        shp[r] = ga;
        wsplit(gp, gm, shh + r, shl + r);
      }
      __syncthreads();
      if (lane == 0 && warp < ng) {  // a warp a tile: its loss, db and da
        const int g0 = warp * TM;
        float s = 0.0f, db = 0.0f, da = 0.0f;
        for (int r = 0; r < TM; ++r) s += sl[g0 + r];
        for (int r = 0; r < TM; ++r) {
          db += shg[g0 + r];
          da += shp[g0 + r];
        }
        tsum[4 * warp] = s;
        tsum[4 * warp + 1] = db;
        tsum[4 * warp + 2] = da;
      }
      for (int g = 0; g < ng; ++g) {
        float acc = 0.0f, acc2 = 0.0f;
        for (int r = g * TM + es; r < (g + 1) * TM; r += TPC) {
          const float xh = __bfloat162float(Xh[ec * RP + r]);
          acc = fmaf(xh, shh[r], acc);
          if (gm == kBf16x2 || gm == kBf16x3) acc2 = fmaf(xh, shl[r], acc2);
          if (gm == kBf16x3)
            acc2 = fmaf(__bfloat162float(Xl[ec * RP + r]), shh[r], acc2);
        }
        red[2 * g * kThreads + es * H + ec] = acc;
        red[(2 * g + 1) * kThreads + es * H + ec] = acc2;
      }
      __syncthreads();
      if (tid == 0) {
        float db[G], da[G];
        for (int g = 0; g < G; ++g) {
          db[g] = tsum[4 * g + 1];
          da[g] = tsum[4 * g + 2];
          if (cot == nullptr && g < ng)
            loss_acc = t + g == c0t ? tsum[4 * g] * args.inv_n
                                    : loss_acc + tsum[4 * g] * args.inv_n;
        }
        put_group(slab + args.off_b[LH], db, ng, t == t_begin);
        if (args.off_a[LH] >= 0)
          put_group(slab + args.off_a[LH], da, ng, t == t_begin);
      }
      if (es == 0) {
        float dw[G];
        for (int g = 0; g < G; ++g) {
          const float* r1 = red + 2 * g * kThreads;
          const float* r2 = r1 + kThreads;
          float s1 = r1[ec], s2 = r2[ec];
          for (int q = 1; q < TPC; ++q) {
            s1 += r1[q * H + ec];
            s2 += r2[q * H + ec];
          }
          dw[g] = s1 + s2;
        }
        put_group(slab + args.off_w[LH] + ec, dw, ng, t == t_begin);
      }
      float whv, wlv;
      wsplit(wp[args.off_w[LH] + ec], gm, &whv, &wlv);
      for (int r = es; r < R; r += TPC) {
        float gh, gl;
        xsplit(shg[r], gm, &gh, &gl);
        dX[r * LDX + ec] = tier_mul(gh, gl, whv, wlv, gm);
      }
      __syncthreads();
    }

    // hidden layers, last to first; then layer 0
    for (int li = L - 2; li >= 0; --li) {
      // ---- gpre = dX * act'(pre) into the G planes (and the unit's
      // planes); db, da ----
      {
        const float* pt = pre_tile + li * (R * H);
        const int kind = args.kind[li], deg = args.deg[li];
        const float omega = args.omega[li];
        const float a = args.off_a[li] >= 0 ? wp[args.off_a[li] + ec] : 1.0f;
        bf16* gph = nullptr;  // the unit's gpre planes of this layer
        if (li > 0)
          gph = up + ((li - 1) * npl + tc_x_planes(gm)) * RCH;
        else if (F > 0)
          gph = up + (L - 2) * npl * RCH;
        with_act(kind, deg, [&](auto act) {
          // runs of 8 of the thread's rows (in each tile es, es + TPC, ...),
          // the next run's pres loaded while this one is computed
          constexpr int CPT = RPT / 8;  // runs a tile
          auto run_row = [&](int ch) {
            return (ch / CPT) * TM + es + (ch % CPT) * 8 * TPC;
          };
          float pv[8], pn[8] = {};
#pragma unroll
          for (int i = 0; i < 8; ++i) pv[i] = pt[(run_row(0) + i * TPC) * H + ec];
          float db = 0.0f, da = 0.0f;
#pragma unroll 1
          for (int ch = 0; ch < ng * CPT; ++ch) {
            const int r0 = run_row(ch);
            if (ch + 1 < ng * CPT) {
              const int rn = run_row(ch + 1);
#pragma unroll
              for (int i = 0; i < 8; ++i) pn[i] = pt[(rn + i * TPC) * H + ec];
            }
            {
              bf16 hi[8], lo[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int r = r0 + i * TPC;
                float ga = 0.0f;
                const float gp =
                    act.grad(pv[i], omega, a, dX[r * LDX + ec], &ga);
                db += gp;
                da += ga;
                split_bf16(gp, &hi[i], &lo[i]);
                if (gph != nullptr) {
                  const long long idx = (lr0 + r) * H + ec;
                  gph[idx] = hi[i];
                  if (gm != kBf16) gph[RCH + idx] = lo[i];
                }
              }
              if constexpr (TPC == 1) {  // 8 rows in a run: one store a plane
                *reinterpret_cast<uint4*>(Xh + ec * RP + r0) = make_uint4(
                    pack2(hi[0], hi[1]), pack2(hi[2], hi[3]),
                    pack2(hi[4], hi[5]), pack2(hi[6], hi[7]));
                *reinterpret_cast<uint4*>(Xl + ec * RP + r0) = make_uint4(
                    pack2(lo[0], lo[1]), pack2(lo[2], lo[3]),
                    pack2(lo[4], lo[5]), pack2(lo[6], lo[7]));
              } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  Xh[ec * RP + r0 + i * TPC] = hi[i];
                  Xl[ec * RP + r0 + i * TPC] = lo[i];
                }
              }
            }
            if ((ch + 1) % CPT == 0) {  // the tile's sums, each in its order
              const int g = ch / CPT;
              red[2 * g * kThreads + es * H + ec] = db;
              red[(2 * g + 1) * kThreads + es * H + ec] = da;
              db = da = 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) pv[i] = pn[i];
          }
        });
        __syncthreads();
        if (es == 0) {
          float sb_[G], sa_[G];
          for (int g = 0; g < G; ++g) {
            const float* r1 = red + 2 * g * kThreads;
            const float* r2 = r1 + kThreads;
            float s1 = r1[ec], s2 = r2[ec];
            for (int q = 1; q < TPC; ++q) {
              s1 += r1[q * H + ec];
              s2 += r2[q * H + ec];
            }
            sb_[g] = s1;
            sa_[g] = s2;
          }
          put_group(slab + args.off_b[li] + ec, sb_, ng, t == t_begin);
          if (args.off_a[li] >= 0)
            put_group(slab + args.off_a[li] + ec, sa_, ng, t == t_begin);
        }
      }
      if (li == 0) break;
      // ---- dX = gpre W^T: hi.hi as FMAs, the cross terms on mma ----
      {
        float hh[8][TC], cr[MT][4][4];
        if (gm == kBf16x3)
          dgrad_product<H, kBf16x3>(ring, Xh, Xl, row0, col0, hh, cr);
        else if (gm == kBf16x2)
          dgrad_product<H, kBf16x2>(ring, Xh, Xl, row0, col0, hh, cr);
        else
          dgrad_product<H, kBf16>(ring, Xh, Xl, row0, col0, hh, cr);
        // dX = hh + cr (dX was last read before the G planes): hh from the
        // FMA tiles (plus cr = 0 where the tier has no cross term), then cr
        // added by the mma blocks that hold it
        const float z = gm == kBf16 ? 0.0f : -0.0f;  // x + -0 is x
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < TC; c += 4)
            *reinterpret_cast<float4*>(dX + (row0 + i) * LDX + col0 + c) =
                make_float4(hh[i][c] + z, hh[i][c + 1] + z, hh[i][c + 2] + z,
                            hh[i][c + 3] + z);
        if (gm != kBf16) {
          __syncthreads();
          const int m0 = (warp / S::WN) * 16 * MT, n0 = (warp % S::WN) * 32;
          const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = m0 + mi * 16 + gid + half * 8;
                const int col = n0 + nj * 8 + tig * 2;
                float2* p = reinterpret_cast<float2*>(dX + row * LDX + col);
                const float2 o = *p;
                *p = make_float2(o.x + cr[mi][nj][half * 2],
                                 o.y + cr[mi][nj][half * 2 + 1]);
              }
        }
        __syncthreads();
      }
    }

    // ---- a raw layer 0's dW: coords^T gpre0, rows split over TPC ----
    if (F == 0) {
      __syncthreads();
      float* part = dX;  // per tile: (TPC, d, H) x 2
      for (int g = 0; g < ng; ++g) {
        float acc[kMaxIn], acc2[kMaxIn];
#pragma unroll
        for (int q = 0; q < kMaxIn; ++q) acc[q] = acc2[q] = 0.0f;
        for (int r = g * TM + es; r < (g + 1) * TM; r += TPC) {
          const float gh = __bfloat162float(Xh[ec * RP + r]);
          const float gl = __bfloat162float(Xl[ec * RP + r]);
#pragma unroll
          for (int q = 0; q < kMaxIn; ++q) {
            if (q < d) {
              float xh, xl;
              xsplit(sc[r * d + q], gm, &xh, &xl);
              acc[q] = fmaf(xh, gh, acc[q]);
              if (gm == kBf16x2 || gm == kBf16x3) acc2[q] = fmaf(xh, gl, acc2[q]);
              if (gm == kBf16x3) acc2[q] = fmaf(xl, gh, acc2[q]);
            }
          }
        }
        float* pg = part + g * 2 * TPC * d * H;
        for (int q = 0; q < d; ++q) {
          pg[(es * d + q) * H + ec] = acc[q];
          pg[TPC * d * H + (es * d + q) * H + ec] = acc2[q];
        }
      }
      __syncthreads();
      if (es == 0) {
        for (int q = 0; q < d; ++q) {
          float dw[G];
          for (int g = 0; g < G; ++g) {
            const float* pg = part + g * 2 * TPC * d * H;
            float s1 = pg[q * H + ec], s2 = pg[TPC * d * H + q * H + ec];
            for (int grp = 1; grp < TPC; ++grp) {
              s1 += pg[(grp * d + q) * H + ec];
              s2 += pg[TPC * d * H + (grp * d + q) * H + ec];
            }
            dw[g] = s1 + s2;
          }
          put_group(slab + args.off_w[0] + q * H + ec, dw, ng, t == t_begin);
        }
      }
    }
  }
  if (tid == 0 && cot == nullptr)
    loss_part[u] = chunk == 0 ? loss_acc : loss_part[u] + loss_acc;
}

template <int H>
struct Dw {
  static constexpr int BM = H < 128 ? H : 128;  // output tile: dW rows
  static constexpr int BN = BM;                 // and columns
  static constexpr int WM = 2;                  // warps along the rows
  static constexpr int WN = BN >= 64 ? 4 : 2;   // and the columns
  static constexpr int MT = BM / WM / 16;       // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;        // n8 tiles a warp (even)
  static constexpr int RC = 64;                 // rows a stage (dW's K)
  static constexpr int AP = BM + 8, BP = BN + 8;
  static constexpr int STAGE = 2 * RC * AP + 2 * RC * BP;  // bf16
  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(2 * STAGE) * 2;
  }
};

static_assert(Dw<256>::smem_bytes() <= 232448, "dW smem");
static_assert(Dw<32>::NT % 2 == 0 && Dw<64>::NT % 2 == 0, "n8 tile pairs");

// dW of one output tile (blockIdx.y) of one unit (blockIdx.x) over the rows
// of chunk `chunk` of its slice: x_in^T gpre for an h x h layer, or [cos;
// sin]^T gpre0 for an RFF layer 0 with the features recomputed from the
// coordinates (x role: rounded in the grad tier).  Both operands are k-major
// (rows) in shared memory and reach the mma through ldmatrix .trans; the
// accumulators run over every row of the chunk in order, and the tile is
// written once (chunk 0 stores, later chunks add).
template <int H, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
siren_dw_kernel(const float* __restrict__ coords, float* __restrict__ partial,
                const bf16* __restrict__ planes, const TrainArgs args, int n,
                int tiles, int slices, int u0, int chunk, int chunk_tiles,
                int rows_cap, long long unit_elems) {
  using D = Dw<H>;
  constexpr int TM = tile_rows<H>();
  constexpr int BM = D::BM, BN = D::BN, AP = D::AP, BP = D::BP, RC = D::RC;
  constexpr int CT = H / BN;  // column tiles of a layer
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = u0 + blockIdx.x;
  const int slice = u % slices;
  const int t_begin = static_cast<int>(static_cast<long long>(slice) * tiles /
                                       slices);
  const int t_end = static_cast<int>(static_cast<long long>(slice + 1) *
                                     tiles / slices);
  const int c0t = t_begin + chunk * chunk_tiles;
  if (c0t >= t_end) return;
  const int K = (min(t_end, c0t + chunk_tiles) - c0t) * TM;  // rows
  const long long row_base = static_cast<long long>(c0t) * TM;
  const int L = args.n_layers, nh = L - 2, F = args.n_freq, d = args.d;
  const long long RCH = static_cast<long long>(rows_cap) * H;
  const int npl = tc_x_planes(MODE) + tc_g_planes(MODE);
  const bf16* up = planes + blockIdx.x * unit_elems;
  const int tpl = CT * CT;
  const bool rff = static_cast<int>(blockIdx.y) >= nh * tpl;
  const int tt = rff ? blockIdx.y - nh * tpl : blockIdx.y % tpl;
  const int j0 = (tt / CT) * BM, c0 = (tt % CT) * BN;
  const bf16 *ah = nullptr, *bh;
  int M;
  float* out = partial + static_cast<long long>(u) * args.P;
  if (!rff) {
    const int q = blockIdx.y / tpl;
    ah = up + q * npl * RCH;
    bh = ah + tc_x_planes(MODE) * RCH;
    M = H;
    out += args.off_w[q + 1];
  } else {
    bh = up + nh * npl * RCH;
    M = 2 * F;
    out += args.off_w[0];
  }

  // rows [kc * RC, + RC) of the chunk into stage st (rows past K zero)
  auto load = [&](int kc, int st) {
    bf16* sAh = sm + st * D::STAGE;
    bf16* sAl = sAh + RC * AP;
    bf16* sBh = sAl + RC * AP;
    bf16* sBl = sBh + RC * BP;
    const int r0 = kc * RC;
    for (int e = tid; e < RC * (BN / 8); e += kThreads) {
      const int r = e / (BN / 8), v = e % (BN / 8);
      const bool ok = r0 + r < K;
      const long long src = (ok ? r0 + r : 0) * static_cast<long long>(H) +
                            c0 + v * 8;
      cp_async16(sBh + r * BP + v * 8, bh + src, ok ? 16 : 0);
      if (MODE != kBf16) cp_async16(sBl + r * BP + v * 8, bh + RCH + src,
                                    ok ? 16 : 0);
    }
    if (!rff) {
      for (int e = tid; e < RC * (BM / 8); e += kThreads) {
        const int r = e / (BM / 8), v = e % (BM / 8);
        const bool ok = r0 + r < K;
        const long long src = (ok ? r0 + r : 0) * static_cast<long long>(H) +
                              j0 + v * 8;
        cp_async16(sAh + r * AP + v * 8, ah + src, ok ? 16 : 0);
        if (MODE == kBf16x3) cp_async16(sAl + r * AP + v * 8, ah + RCH + src,
                                        ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < RC * BM; e += kThreads) {
        const int r = e / BM, j = e % BM;
        const long long row = row_base + r0 + r;
        float v = 0.0f;
        if (r0 + r < K && row < n && j0 + j < M)
          v = rff_feature(coords + row * d, args.bt, d, F, j0 + j, args.fdeg);
        const bf16 hi = __float2bfloat16_rn(v);
        sAh[r * AP + j] = hi;
        if (MODE == kBf16x3)
          sAl[r * AP + j] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
    }
  };

  const int wm = warp / D::WN, wn = warp % D::WN;
  const bool active = warp < D::WM * D::WN;
  const int m0 = wm * (BM / D::WM), n0 = wn * (BN / D::WN);
  float hh[D::MT][D::NT][4], cr[D::MT][D::NT][4];
#pragma unroll
  for (int mi = 0; mi < D::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < D::NT; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) hh[mi][nj][q] = cr[mi][nj][q] = 0.0f;
  const int nck = (K + RC - 1) / RC;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nck; ++kc) {
    cp_async_wait<0>();
    __syncthreads();  // stage kc has landed; stage kc - 1 is consumed
    if (kc + 1 < nck) load(kc + 1, (kc + 1) & 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* sAh = sm + (kc & 1) * D::STAGE;
    const bf16* sAl = sAh + RC * AP;
    const bf16* sBh = sAl + RC * AP;
    const bf16* sBl = sBh + RC * BP;
#pragma unroll
    for (int ks = 0; ks < RC; ks += 16) {
      unsigned af[D::MT][4], al[D::MT][4] = {};
#pragma unroll
      for (int mi = 0; mi < D::MT; ++mi) {
        const int off = (ks + (lane & 7) + ((lane >> 4) & 1) * 8) * AP + m0 +
                        mi * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(af[mi], sAh + off);
        if (MODE == kBf16x3) ldsm_x4_t(al[mi], sAl + off);
      }
#pragma unroll
      for (int nj = 0; nj < D::NT; nj += 2) {
        const int off = (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BP + n0 +
                        nj * 8 + (lane >> 4) * 8;
        unsigned bf[4], bl[4] = {};
        ldsm_x4_t(bf, sBh + off);
        if (MODE != kBf16) ldsm_x4_t(bl, sBl + off);
#pragma unroll
        for (int mi = 0; mi < D::MT; ++mi) {
          tier_mma_f32<MODE>(hh[mi][nj], cr[mi][nj], af[mi], al[mi], bf[0], bf[1],
                         bl[0], bl[1]);
          tier_mma_f32<MODE>(hh[mi][nj + 1], cr[mi][nj + 1], af[mi], al[mi],
                         bf[2], bf[3], bl[2], bl[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < D::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < D::NT; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j0 + m0 + mi * 16 + gid + half * 8;
        if (j >= M) continue;
        const int c = c0 + n0 + nj * 8 + tig * 2;
        float2* p = reinterpret_cast<float2*>(out + static_cast<long long>(j) * H + c);
        float2 v = make_float2(hh[mi][nj][half * 2] + cr[mi][nj][half * 2],
                               hh[mi][nj][half * 2 + 1] +
                                   cr[mi][nj][half * 2 + 1]);
        if (chunk > 0) {
          const float2 o = *p;
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *p = v;
      }
}

template <int H>
int launch_sweep(const TrainArgs& args, const float* coords,
                 const float* params, const bf16* whi, const bf16* wlo,
                 float* partial, float* loss_part, float* pre, bf16* planes,
                 const float* tgt, const float* cot, const int* limit, int n,
                 int slices, int u0, int units, int chunk, int chunk_tiles,
                 int rows_cap, long long unit_elems, long long wq, int group,
                 cudaStream_t stream) {
  if (group != Sw<H>::G) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Sw<H>::smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      siren_sweep_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + tile_rows<H>() - 1) / tile_rows<H>();
  const int per = min(chunk_tiles, (tiles + slices - 1) / slices);
  if (slices > tiles || chunk_tiles < 1 || rows_cap < per * tile_rows<H>())
    return static_cast<int>(cudaErrorInvalidValue);
  siren_sweep_kernel<H><<<units, kThreads, smem, stream>>>(
      coords, params, whi, wlo, partial, loss_part, pre, planes, tgt, cot,
      limit, args, n, tiles, slices, u0, chunk, chunk_tiles, rows_cap,
      unit_elems, wq);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int MODE>
int launch_dw_mode(const TrainArgs& args, const float* coords,
                   float* partial, const bf16* planes, int n, int slices,
                   int u0, int units, int chunk, int chunk_tiles,
                   int rows_cap, long long unit_elems, cudaStream_t stream) {
  using D = Dw<H>;
  const size_t smem = D::smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      siren_dw_kernel<H, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + tile_rows<H>() - 1) / tile_rows<H>();
  const int ct = H / D::BN;
  const int ny = (args.n_layers - 2) * ct * ct +
                 (args.n_freq > 0 ? (2 * args.n_freq + D::BM - 1) / D::BM * ct
                                  : 0);
  if (ny == 0) return 0;  // no h x h layer and a raw layer 0
  siren_dw_kernel<H, MODE><<<dim3(units, ny), kThreads, smem, stream>>>(
      coords, partial, planes, args, n, tiles, slices, u0, chunk,
      chunk_tiles, rows_cap, unit_elems);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_dw(const TrainArgs& args, const float* coords, float* partial,
              const bf16* planes, int n, int slices, int u0, int units,
              int chunk, int chunk_tiles, int rows_cap, long long unit_elems,
              cudaStream_t stream) {
  switch (args.gmode) {
    case kBf16x3:
      return launch_dw_mode<H, kBf16x3>(args, coords, partial, planes, n,
                                        slices, u0, units, chunk, chunk_tiles,
                                        rows_cap, unit_elems, stream);
    case kBf16x2:
      return launch_dw_mode<H, kBf16x2>(args, coords, partial, planes, n,
                                        slices, u0, units, chunk, chunk_tiles,
                                        rows_cap, unit_elems, stream);
    default:
      return launch_dw_mode<H, kBf16>(args, coords, partial, planes, n,
                                      slices, u0, units, chunk, chunk_tiles,
                                      rows_cap, unit_elems, stream);
  }
}

// Block-wide sum of one float per thread in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
  return s;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
siren_reduce_kernel(const float* __restrict__ partial,
                    float* __restrict__ grads, float* __restrict__ sq_part,
                    const float* __restrict__ loss_part,
                    float* __restrict__ loss_out, int slices, int P,
                    int chunks) {
  __shared__ float scratch[kThreads / 32];
  const long long win = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  if (loss_out != nullptr && chunk == 0 && threadIdx.x == 0) {
    // E: the window's loss, its slices summed in order as the Adam kernel
    // sums them
    float loss = 0.0f;
    for (int s = 0; s < slices; ++s) loss += loss_part[win * slices + s];
    loss_out[win] = loss;
  }
  const int e = chunk * kChunk + threadIdx.x * 4;
  float sq = 0.0f;
  if (e < P) {
    const float* src = partial + win * slices * static_cast<long long>(P) + e;
    float4 acc = __ldg(reinterpret_cast<const float4*>(src));
    for (int s = 1; s < slices; ++s) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<long long>(s) * P));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    *reinterpret_cast<float4*>(grads + win * P + e) = acc;
    sq = ((acc.x * acc.x + acc.y * acc.y) + acc.z * acc.z) + acc.w * acc.w;
  }
  const float total = block_sum(sq, scratch);
  if (threadIdx.x == 0) sq_part[win * chunks + chunk] = total;
}

// ---------------------------------------------------------------------------
// The optimizer epilogue: clip + Adam + best snapshot (D's last two launches,
// and F).  Replaces the last-tile epilogue of
// inraudio_tpu/ops/pallas_siren_step.py:_step_kernel and that file's
// _adam_kernel.  It is bound by bytes: g, p, mu and nu read once and p, mu,
// nu (and best, where the window improved) written once, 7-8 floats an
// element against ~12 fp32 operations.  So each window's norm is computed
// once (siren_scale_kernel; in F by each CTA after a grid-wide sync), and
// the update streams float4s, several a thread in flight, each warp's
// access a run of 512 contiguous bytes.  The summation order fixes the
// clip scale bit for bit: the chunk sums of squares in the reduce's order,
// the chunks and the loss slices in index order; the element expression
// rounds op by op (-fmad=false).
// ---------------------------------------------------------------------------

constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
// float4 a thread of siren_adam_kernel, loaded before any is updated
constexpr int kAdamVec = 4;
// floats of one siren_adam_kernel CTA (a window's span): 4096
constexpr int kAdamSpan = kThreads * kAdamVec * 4;
static_assert(kAdamSpan % kChunk == 0, "a span is whole chunks");

// One element: clip and Adam -> the new p (mu and nu updated in place).
// The order of every operation is the reference's.
__device__ __forceinline__ float adam_elem(float g, float p_old, float& mu,
                                           float& nu, float scale, bool clip,
                                           float lr, float c1, float c2) {
  if (clip) g = g * scale;
  const float m = kB1 * mu + kOneMinusB1 * g;
  const float v = kB2 * nu + kOneMinusB2 * g * g;
  mu = m;
  nu = v;
  return p_old - lr * (m / c1) / (sqrtf(v / c2) + kEps);
}

__device__ __forceinline__ void adam_float4(const float4 g, float4& p,
                                            float4& m, float4& v,
                                            float scale, bool clip, float lr,
                                            float c1, float c2) {
  p.x = adam_elem(g.x, p.x, m.x, v.x, scale, clip, lr, c1, c2);
  p.y = adam_elem(g.y, p.y, m.y, v.y, scale, clip, lr, c1, c2);
  p.z = adam_elem(g.z, p.z, m.z, v.z, scale, clip, lr, c1, c2);
  p.w = adam_elem(g.w, p.w, m.w, v.w, scale, clip, lr, c1, c2);
}

// The clip scale of a sum of squares (1 without a clip).
__device__ __forceinline__ float clip_scale(float sq, float clip) {
  float scale = 1.0f;
  if (clip > 0.0f) scale = fminf(1.0f, clip / fmaxf(sqrtf(sq), 1e-20f));
  return scale;
}

// The sum of src[0, n) in index order from 0, as one thread adds it up,
// with the loads coalesced and in flight together: staged through shared
// memory kThreads at a time, then added by thread 0.  Valid in thread 0;
// every thread of the CTA calls it.
__device__ float ordered_sum(const float* src, int n, float* staged) {
  float s = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int m = min(kThreads, n - i0);
    if (threadIdx.x < m) staged[threadIdx.x] = __ldcg(src + i0 + threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < m; ++i) s += staged[i];
    __syncthreads();
  }
  return s;
}

// D: one CTA per window.  Its chunks' sums of squares and its slices'
// losses, each summed in index order -> scale[w] and loss_out[w].
__global__ void __launch_bounds__(kThreads)
siren_scale_kernel(const float* __restrict__ sq_part,
                   const float* __restrict__ loss_part,
                   float* __restrict__ scale, float* __restrict__ loss_out,
                   int slices, int chunks, float clip) {
  __shared__ float staged[kThreads];
  const long long w = blockIdx.x;
  const float sq = ordered_sum(sq_part + w * chunks, chunks, staged);
  const float loss = ordered_sum(loss_part + w * slices, slices, staged);
  if (threadIdx.x == 0) {
    scale[w] = clip_scale(sq, clip);
    loss_out[w] = loss;
  }
}

// D: per (window, span of kAdamSpan floats); thread t updates the float4s t,
// t + 256, t + 512, t + 768 of its span, all four loaded first.  P is a
// multiple of 4, so no float4 crosses a window.
__global__ void __launch_bounds__(kThreads)
siren_adam_kernel(const float* __restrict__ grads,
                  const float* __restrict__ scale,
                  const float* __restrict__ loss,
                  float* __restrict__ params, float* __restrict__ mu,
                  float* __restrict__ nu, float* __restrict__ best,
                  const float* __restrict__ lr, const float* __restrict__ c1,
                  const float* __restrict__ c2,
                  const float* __restrict__ best_loss, int P, int spans,
                  float clip) {
  const long long win = blockIdx.x / spans;
  const int span = blockIdx.x % spans;
  const int q = P / 4;  // float4 a window
  const int f0 = span * (kAdamSpan / 4) + threadIdx.x;
  const float sc = __ldg(scale + win), lr_w = __ldg(lr + win),
              c1_w = __ldg(c1 + win), c2_w = __ldg(c2 + win);
  const bool improved = best != nullptr &&
                        __ldg(loss + win) < __ldg(best_loss + win);
  const bool clipped = clip > 0.0f;
  const long long base = win * q;
  const float4* g4 = reinterpret_cast<const float4*>(grads) + base;
  float4* p4 = reinterpret_cast<float4*>(params) + base;
  float4* m4 = reinterpret_cast<float4*>(mu) + base;
  float4* v4 = reinterpret_cast<float4*>(nu) + base;
  float4 g[kAdamVec], p[kAdamVec], m[kAdamVec], v[kAdamVec];
#pragma unroll
  for (int j = 0; j < kAdamVec; ++j) {
    const int f = f0 + j * kThreads;
    if (f < q) {
      g[j] = __ldg(g4 + f);
      p[j] = p4[f];
      m[j] = m4[f];
      v[j] = v4[f];
    }
  }
#pragma unroll
  for (int j = 0; j < kAdamVec; ++j) {
    const int f = f0 + j * kThreads;
    if (f < q) {
      if (improved) reinterpret_cast<float4*>(best)[base + f] = p[j];
      adam_float4(g[j], p[j], m[j], v[j], sc, clipped, lr_w, c1_w, c2_w);
      p4[f] = p[j];
      m4[f] = m[j];
      v4[f] = v[j];
    }
  }
}

// F on one model: g = buf (P + 4) = [grads | loss | pad], all-reduced.  A
// cooperative launch of gridDim.x <= the co-resident CTAs; CTA b takes the
// chunks b, b + gridDim.x, ... in both halves.  First half: each chunk's
// sum of squares as the reduce computes it (float4 lanes, then block_sum's
// fixed tree) into sq_part; the CTA's first chunk of g, p, mu and nu is
// loaded into registers there, so its loads overlap the sync.  After the
// grid-wide sync every CTA sums sq_part in chunk order (ordered_sum), so
// each CTA holds the same norm bit for bit; then the update, one float4 a
// thread a chunk (at the runner's P every CTA has one chunk, all of it in
// registers).
__global__ void __launch_bounds__(kThreads)
siren_adam_global_kernel(const float* __restrict__ g,
                         float* __restrict__ sq_part,
                         float* __restrict__ params, float* __restrict__ mu,
                         float* __restrict__ nu, float* __restrict__ best,
                         float* __restrict__ loss_out,
                         const float* __restrict__ lr,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2,
                         const float* __restrict__ best_loss, int P,
                         int chunks, float clip) {
  __shared__ float scratch[kThreads / 32];
  __shared__ float staged[kThreads];
  __shared__ float s_scale;
  __shared__ bool s_improved;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* p4 = reinterpret_cast<float4*>(params);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  const int q = P / 4;
  // the first chunk's float4 of this thread (gridDim.x <= chunks)
  const int f1 = blockIdx.x * (kChunk / 4) + threadIdx.x;
  float4 g1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), p1 = g1, m1 = g1, v1 = g1;
  if (f1 < q) {
    g1 = __ldg(g4 + f1);
    p1 = p4[f1];
    m1 = m4[f1];
    v1 = v4[f1];
  }
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int f = c * (kChunk / 4) + threadIdx.x;
    float sq = 0.0f;
    if (f < q) {
      const float4 v = c == blockIdx.x ? g1 : __ldg(g4 + f);
      sq = ((v.x * v.x + v.y * v.y) + v.z * v.z) + v.w * v.w;
    }
    const float total = block_sum(sq, scratch);
    if (threadIdx.x == 0) sq_part[c] = total;
    __syncthreads();  // scratch is read by thread 0 before it is rewritten
  }
  cooperative_groups::this_grid().sync();
  const float sq = ordered_sum(sq_part, chunks, staged);
  // the buffer's loss: one slice, summed as D sums its slices
  const float loss = ordered_sum(g + P, 1, staged);
  if (threadIdx.x == 0) {
    s_scale = clip_scale(sq, clip);
    s_improved = best != nullptr && loss < __ldg(best_loss);
    if (blockIdx.x == 0) loss_out[0] = loss;
  }
  __syncthreads();
  const float sc = s_scale, lr_w = __ldg(lr), c1_w = __ldg(c1),
              c2_w = __ldg(c2);
  const bool improved = s_improved, clipped = clip > 0.0f;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int f = c * (kChunk / 4) + threadIdx.x;
    if (f >= q) continue;
    float4 gv = g1, p = p1, m = m1, v = v1;
    if (c != blockIdx.x) {
      gv = __ldg(g4 + f);
      p = p4[f];
      m = m4[f];
      v = v4[f];
    }
    if (improved) reinterpret_cast<float4*>(best)[f] = p;
    adam_float4(gv, p, m, v, sc, clipped, lr_w, c1_w, c2_w);
    p4[f] = p;
    m4[f] = m;
    v4[f] = v;
  }
}

template <int H>
int launch_grad(const TrainArgs& args, const float* coords,
                const float* params, float* partial, float* loss_part,
                float* pre, const float* tgt, const float* cot,
                const int* limit, int k, int n, int slices,
                cudaStream_t stream) {
  const size_t smem = train_smem_floats<H>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      siren_grad_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + tile_rows<H>() - 1) / tile_rows<H>();
  if (slices > tiles) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(slices) * k;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  siren_grad_kernel<H><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(coords, params, partial, loss_part, pre,
                                   tgt, cot, limit, args, n, tiles,
                                   slices);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' arguments from the wrapper's host arrays: offs = w, b, a
// offsets per layer; ints = kind, forward mode, degree per layer.
TrainArgs make_args(const void* offs, const void* ints, const void* omegas,
                    int n_layers, int d, int P, int gmode, float inv_n,
                    float two_inv_n, const void* bt, int n_freq, int fdeg,
                    int h_real) {
  TrainArgs args;
  const int* o = static_cast<const int*>(offs);
  const int* q = static_cast<const int*>(ints);
  const float* om = static_cast<const float*>(omegas);
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool live = l < n_layers;
    args.off_w[l] = live ? o[3 * l] : 0;
    args.off_b[l] = live ? o[3 * l + 1] : 0;
    args.off_a[l] = live ? o[3 * l + 2] : -1;
    args.kind[l] = live ? q[3 * l] : kLinear;
    args.mode[l] = live ? q[3 * l + 1] : kHighest;
    args.deg[l] = live ? q[3 * l + 2] : 0;
    args.omega[l] = live ? om[l] : 0.0f;
  }
  args.n_layers = n_layers;
  args.d = d;
  args.P = P;
  args.gmode = gmode;
  args.inv_n = inv_n;
  args.two_inv_n = two_inv_n;
  args.bt = static_cast<const float*>(bt);
  args.n_freq = n_freq;
  args.fdeg = fdeg;
  args.h_real = h_real;
  args.wgt = nullptr;
  return args;
}

// Whether the tensor-core route takes these tiers: the grad tier and the
// forward tier of every product (layers 1+, and an RFF layer 0) in bf16,
// bf16x2 or bf16x3.
bool tc_tiers(const TrainArgs& a) {
  if (a.gmode == kHighest) return false;
  for (int l = a.n_freq > 0 ? 0 : 1; l < a.n_layers; ++l)
    if (a.mode[l] == kHighest) return false;
  return true;
}

}  // namespace

extern "C" {

// coords (n, d), params (k, P), partial (k * slices, P), loss_part
// (k * slices), pre (k * slices, n_layers, 8192): device float32.  tgt
// (k, n) for the MSE step, or cot (k, n) for the backward (tgt null).  k
// may be a group of a larger population: the caller offsets params, tgt /
// cot and loss_part to the group's first window.  offs: host int32[3 *
// n_layers] = w, b, a offsets per layer; ints: host int32[3 * n_layers] =
// kind, forward mode, degree; omegas: host float[n_layers].  bt: device
// (d, F) f32 = 2 pi B^T of an RFF model (n_freq = F > 0, layer 0's w is
// (2F, h)), or null with n_freq = 0; fdeg: the features' trig degree.
// slices: row slices per window, 1 <= slices <= the window's row tiles.
// limit: device int32 (E's row limit: rows at or past it carry no loss), or
// null for every row; inv_n / two_inv_n normalise the loss and cotangent.
// wgt: device (k, n) f32 per-row loss weight of the MSE step (D, E; with
// tgt only), offset like tgt, or null for none.
// Returns a cudaError_t value: 0 when accepted.
int siren_grad(const void* coords, const void* params, void* partial,
               void* loss_part, void* pre, const void* tgt, const void* cot,
               const void* offs, const void* ints, const void* omegas,
               int n_layers, int k, int n, int d, int h, int h_real, int P,
               int gmode,
               float inv_n, float two_inv_n, const void* bt, int n_freq,
               int fdeg, int slices, const void* limit, const void* wgt,
               void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn || k < 1 ||
      n < 1 || P < 1 || (P & 3) || (tgt == nullptr) == (cot == nullptr) ||
      (wgt != nullptr && tgt == nullptr) ||
      slices < 1 || n_freq < 0 || (n_freq > 0) != (bt != nullptr) ||
      h_real < 1 || h_real > h)
    return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs args = make_args(offs, ints, omegas, n_layers, d, P, gmode,
                             inv_n, two_inv_n, bt, n_freq, fdeg, h_real);
  args.wgt = static_cast<const float*>(wgt);
  const float* c = static_cast<const float*>(coords);
  const float* p = static_cast<const float*>(params);
  float* part = static_cast<float*>(partial);
  float* lp = static_cast<float*>(loss_part);
  float* pr = static_cast<float*>(pre);
  const float* t = static_cast<const float*>(tgt);
  const float* ct = static_cast<const float*>(cot);
  const int* lim = static_cast<const int*>(limit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32: return launch_grad<32>(args, c, p, part, lp, pr, t, ct, lim, k, n, slices, s);
    case 64: return launch_grad<64>(args, c, p, part, lp, pr, t, ct, lim, k, n, slices, s);
    case 128: return launch_grad<128>(args, c, p, part, lp, pr, t, ct, lim, k, n, slices, s);
    case 256: return launch_grad<256>(args, c, p, part, lp, pr, t, ct, lim, k, n, slices, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partial (k * slices, P) -> grads (k, P), sq_part (k, chunks).  With
// loss_out (E): loss_out[w] = the sum of loss_part[w * slices + s] over s.
int siren_reduce(const void* partial, void* grads, void* sq_part,
                 const void* loss_part, void* loss_out, int k, int slices,
                 int P, void* stream) {
  if (k < 1 || slices < 1 || P < 1 || (P & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (P + kChunk - 1) / kChunk;
  const long long blocks = static_cast<long long>(k) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  siren_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads),
      static_cast<float*>(sq_part), static_cast<const float*>(loss_part),
      static_cast<float*>(loss_out), slices, P, chunks);
  return static_cast<int>(cudaGetLastError());
}

// D's epilogue, two launches: siren_scale_kernel over k CTAs, then
// siren_adam_kernel over k * spans CTAs (spans = ceil(P / 4096), from the wrapper's plan).
// In place on params / mu / nu / best (k, P; best may be null); scale (k)
// scratch; loss_out (k) receives each window's loss, the sum of its slices'
// loss_part; sq_part (k, chunks) from the reduce; lr, c1, c2, best_loss (k)
// are read.
int siren_adam(const void* grads, const void* sq_part, const void* loss_part,
               void* params, void* mu, void* nu, void* best, void* loss_out,
               void* scale, const void* lr, const void* c1, const void* c2,
               const void* best_loss, int k, int slices, int P, int spans,
               float clip, void* stream) {
  if (k < 1 || slices < 1 || P < 1 || (P & 3) ||
      spans != (P + kAdamSpan - 1) / kAdamSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (P + kChunk - 1) / kChunk;
  const long long blocks = static_cast<long long>(k) * spans;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scale);
  float* lo = static_cast<float*>(loss_out);
  siren_scale_kernel<<<k, kThreads, 0, s>>>(
      static_cast<const float*>(sq_part), static_cast<const float*>(loss_part),
      sc, lo, slices, chunks, clip);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  siren_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(grads), sc, lo, static_cast<float*>(params),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(best), static_cast<const float*>(lr),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<const float*>(best_loss), P, spans, clip);
  return static_cast<int>(cudaGetLastError());
}

// The most CTAs of siren_adam_global_kernel that the current device holds
// at once (the cooperative launch's limit), or minus a cudaError_t value.
int siren_adam_global_cap() {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, siren_adam_global_kernel, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (!coop || per_sm < 1)
    return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sms;
}

// F, one cooperative launch of `grid` CTAs (1 <= grid <= the chunks and
// siren_adam_global_cap()): buf (P + 4) = [grads (P) | loss | pad],
// all-reduced; sq_part (chunks) scratch.  In place on params / mu / nu /
// best (P; best may be null) of one model; loss_out (1) receives buf[P];
// lr, c1, c2, best_loss (1) are read.  The norm is that of buf's grads, the
// best snapshot taken when buf[P] < best_loss.
int siren_adam_global(const void* buf, void* sq_part, void* params, void* mu,
                      void* nu, void* best, void* loss_out, const void* lr,
                      const void* c1, const void* c2, const void* best_loss,
                      int P, int grid, float clip, void* stream) {
  if (P < 1 || (P & 3)) return static_cast<int>(cudaErrorInvalidValue);
  int chunks = (P + kChunk - 1) / kChunk;
  if (grid < 1 || grid > chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(buf);
  float* sq = static_cast<float*>(sq_part);
  float* p = static_cast<float*>(params);
  float* m = static_cast<float*>(mu);
  float* v = static_cast<float*>(nu);
  float* b = static_cast<float*>(best);
  float* lo = static_cast<float*>(loss_out);
  const float* lr_ = static_cast<const float*>(lr);
  const float* c1_ = static_cast<const float*>(c1);
  const float* c2_ = static_cast<const float*>(c2);
  const float* bl = static_cast<const float*>(best_loss);
  void* args[] = {&g, &sq, &p, &m, &v, &b, &lo, &lr_, &c1_, &c2_, &bl, &P,
                  &chunks, &clip};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)siren_adam_global_kernel, dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}


// The tensor-core route (bf16, bf16x2, bf16x3 tiers).  Windows are those of
// one launch group: the caller offsets params / tgt / cot / loss_part to the
// group's first window, and whi / wlo (k, wq) bf16, wq = 2 (n_layers - 2)
// h^2 + 2 n_freq h (tc_wq), hold that group's planes (siren_wsplit).  A
// unit u = w * slices + s is window w's row slice s; partial (k * slices,
// P) and loss_part (k * slices) are indexed by it.  A pass runs units [u0,
// u0 + units) over the tiles of chunk `chunk` of their slices (chunk_tiles
// tiles a chunk); its pre (units, n_layers, group * 8192) f32 and planes
// (units, unit_elems) bf16 scratch are indexed by u - u0, each unit's
// planes rows_cap rows of h.  group: the row tiles a sweep CTA carries at
// once at this h (Sw<H>::G), which the pre scratch is sized by; any other
// value is refused.  wgt: as siren_grad's.  Every call returns a
// cudaError_t value: 0 when accepted.
int siren_wsplit(const void* params, void* whi, void* wlo, const void* offs,
                 const void* ints, const void* omegas, int n_layers, int k,
                 int h, int P, int n_freq, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || k < 1 || P < 1 || n_freq < 0 ||
      (h != 32 && h != 64 && h != 128 && h != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const TrainArgs args = make_args(offs, ints, omegas, n_layers, 1, P,
                                   kBf16x2, 1.0f, 2.0f, nullptr, n_freq, 0,
                                   h);
  const long long wq = tc_wq(n_layers, h, n_freq);
  if (wq == 0) return 0;
  const long long blocks = std::min((wq * k + kThreads - 1) / kThreads,
                                    65536LL);
  siren_wsplit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<bf16*>(whi),
      static_cast<bf16*>(wlo), args, h, wq, k);
  return static_cast<int>(cudaGetLastError());
}

int siren_sweep(const void* coords, const void* params, const void* whi,
                const void* wlo, void* partial, void* loss_part, void* pre,
                void* planes, const void* tgt, const void* cot,
                const void* offs, const void* ints, const void* omegas,
                int n_layers, int n, int d, int h, int h_real, int P,
                int gmode, float inv_n, float two_inv_n, const void* bt,
                int n_freq, int fdeg, int slices, int u0, int units,
                int chunk, int chunk_tiles, int rows_cap,
                long long unit_elems, int group, const void* limit,
                const void* wgt, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn ||
      n < 1 || P < 1 || (P & 3) || (tgt == nullptr) == (cot == nullptr) ||
      (wgt != nullptr && tgt == nullptr) ||
      slices < 1 || u0 < 0 || units < 1 || chunk < 0 || n_freq < 0 ||
      (n_freq > 0) != (bt != nullptr) || h_real < 1 || h_real > h)
    return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs args = make_args(offs, ints, omegas, n_layers, d, P, gmode,
                             inv_n, two_inv_n, bt, n_freq, fdeg, h_real);
  args.wgt = static_cast<const float*>(wgt);
  if (!tc_tiers(args)) return static_cast<int>(cudaErrorInvalidValue);
  const long long wq = tc_wq(n_layers, h, n_freq);
  const float* c = static_cast<const float*>(coords);
  const float* p = static_cast<const float*>(params);
  const bf16* wh = static_cast<const bf16*>(whi);
  const bf16* wl = static_cast<const bf16*>(wlo);
  float* part = static_cast<float*>(partial);
  float* lp = static_cast<float*>(loss_part);
  float* pr = static_cast<float*>(pre);
  bf16* pl = static_cast<bf16*>(planes);
  const float* t = static_cast<const float*>(tgt);
  const float* ct = static_cast<const float*>(cot);
  const int* lim = static_cast<const int*>(limit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWEEP(H)                                                            \
  launch_sweep<H>(args, c, p, wh, wl, part, lp, pr, pl, t, ct, lim, n,       \
                  slices, u0, units, chunk, chunk_tiles, rows_cap,           \
                  unit_elems, wq, group, s)
  switch (h) {
    case 32: return SWEEP(32);
    case 64: return SWEEP(64);
    case 128: return SWEEP(128);
    case 256: return SWEEP(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWEEP
}

int siren_dw(const void* coords, void* partial, const void* planes,
             const void* offs, const void* ints, const void* omegas,
             int n_layers, int n, int d, int h, int P, int gmode,
             const void* bt, int n_freq, int fdeg, int slices, int u0,
             int units, int chunk, int chunk_tiles, int rows_cap,
             long long unit_elems, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || d < 1 || d > kMaxIn ||
      n < 1 || P < 1 || (P & 3) || slices < 1 || u0 < 0 || units < 1 ||
      chunk < 0 || chunk_tiles < 1 || n_freq < 0 ||
      (n_freq > 0) != (bt != nullptr) || gmode == kHighest)
    return static_cast<int>(cudaErrorInvalidValue);
  const TrainArgs args = make_args(offs, ints, omegas, n_layers, d, P, gmode,
                                   1.0f, 2.0f, bt, n_freq, fdeg, h);
  const float* c = static_cast<const float*>(coords);
  float* part = static_cast<float*>(partial);
  const bf16* pl = static_cast<const bf16*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DW(H)                                                               \
  launch_dw<H>(args, c, part, pl, n, slices, u0, units, chunk, chunk_tiles,  \
               rows_cap, unit_elems, s)
  switch (h) {
    case 32: return DW(32);
    case 64: return DW(64);
    case 128: return DW(128);
    case 256: return DW(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DW
}

}  // extern "C"
