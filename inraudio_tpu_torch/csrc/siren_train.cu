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
//   packed bf16 hi/lo planes, once per launch group (the w-role split);
// - siren_sweep_kernel, per unit = (window, row slice), over the tiles of
//   one row chunk of its slice: the forward recompute, the cotangent, the
//   head (narrow FMAs), and the dgrad sweep, with W streamed in K-slabs of
//   packed bf16 planes by cp.async (two stages; W^T read from W's rows).
//   For each h x h layer it writes dW's operands once, as bf16 planes, into
//   the unit's scratch: x_in's hi (and lo in bf16x3) and gpre's hi (and lo
//   in bf16x2 / bf16x3); for an RFF model gpre0's.  db, da, the head's dW
//   and a raw layer 0's dW go to the unit's slab as before (its first tile
//   stores, later tiles add: a few H floats a layer);
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
// - the dgrad: the cross term on the tensor cores, hi.hi as fp32 FMAs in k
//   order (the plain version's own order);
// - the forward of layers 1+: every term as fp32 FMAs, in the FMA kernel's
//   chains, so its pres are that kernel's bit for bit.
// Why not everything on the tensor cores: the tensor core sums 16 products
// at a time (with truncation), and an ulp of difference in a pre is
// multiplied by omega in the next sine and flips the bf16 rounding of later
// operands.  On an H100 an all-mma sweep was faster but moved C's bf16x3
// gradients past the card tests' f32 bound (2e-6 of the largest) and D's
// bf16x2 state past its bulk bound; with only hi.hi in the reference's
// order the card tests passed, but the headline encode's 300-step fit left
// the plain-step fit by more than chip_smoke's 1 dB of median per-hop SNR.
// With the whole forward in the FMA kernel's order every gate passes.
// Determinism: no float atomics; the slices and chunks are functions of the
// shapes (ops/siren_train.py: tc_plan), so the grouping of windows and
// units into passes leaves every result bit-equal.
// ===========================================================================

// Which of the sweep's h x h products run as fp32 FMAs in the reference's
// k order, the rest on mma.sync: 2 (the route) every term of the forward
// and the dgrad's hi.hi; 1 the hi.hi of both; 0 none.  1 and 0 fail the
// gates against the plain versions (PERF.md §6); ops/sweep_ab.py builds
// them to time them and to read those gates.
#ifndef SIREN_SWEEP_SEQ
#define SIREN_SWEEP_SEQ 2
#endif

template <int H>
struct Tc {
  static constexpr int TM = tile_rows<H>();
  static constexpr int LDB = H + 8;           // X / G plane pitch (bf16)
  static constexpr int LDX = H + 4;           // dX pitch (f32)
  static constexpr int KS = H < 64 ? H : 64;  // W slab depth
  static constexpr int WN = H / 32;           // warps along the columns
  // one W slab plane: KS rows x H (forward) or H rows x KS (dgrad)
  static constexpr int WSP =
      KS * (H + 8) > H * (KS + 8) ? KS * (H + 8) : H * (KS + 8);
  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(2 * TM * LDB) * 2  // X / G planes
           + static_cast<size_t>(4 * WSP) * 2     // 2 stages x hi / lo
           + static_cast<size_t>(TM * LDX) * 4    // dX
           + static_cast<size_t>(2 * H + TM * kMaxIn + 5 * TM + 2 * kThreads) * 4;
  }
};

static_assert(Tc<32>::smem_bytes() <= 232448, "sweep smem h=32");
static_assert(Tc<64>::smem_bytes() <= 232448, "sweep smem h=64");
static_assert(Tc<128>::smem_bytes() <= 232448, "sweep smem h=128");
static_assert(Tc<256>::smem_bytes() <= 232448, "sweep smem h=256");

// Planes of a unit's scratch: for each h x h layer x_in hi, [x_in lo in
// bf16x3], gpre hi, [gpre lo in bf16x2 / bf16x3], each (rows_cap x H); then
// an RFF model's gpre0 hi, [lo].  ops/siren_train.py: tc_unit_planes.
__host__ __device__ inline int tc_x_planes(int gm) { return gm == kBf16x3 ? 2 : 1; }
__host__ __device__ inline int tc_g_planes(int gm) { return gm == kBf16 ? 1 : 2; }

// One K-slab's product on the tensor cores for the warp's 32 x 32 block of
// a (TM x H) output: A (TM rows, pitch LDB) from column acol0, in the x
// role; B the slab in shared memory, in the w role: (KS x H, pitch H + 8)
// read with .trans (the forward: W's rows), or (H x KS, pitch KS + 8) read
// as is (the dgrad: columns of W, i.e. rows of W^T).  With HH every term
// of the tier (hi.hi into hh, the cross terms into cr), else the cross
// terms alone (hi.hi runs as FMAs: seq_hh_slab, seq_fwd_slab).
template <int H, int MODE, bool DGRAD, bool HH>
__device__ __forceinline__ void tc_slab(const bf16* Ah, const bf16* Al,
                                        int acol0, const bf16* Bh,
                                        const bf16* Bl, int ksteps,
                                        float (&hh)[2][4][4],
                                        float (&cr)[2][4][4]) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / C::WN) * 32, n0 = (warp % C::WN) * 32;
#pragma unroll 1
  for (int s = 0; s < ksteps; ++s) {
    const int kk = s * 16;
    unsigned ah[2][4], al[2][4] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int off = (r0 + mi * 16 + (lane & 15)) * C::LDB + acol0 + kk +
                      (lane >> 4) * 8;
      ldsm_x4(ah[mi], Ah + off);
      if (MODE == kBf16x3) ldsm_x4(al[mi], Al + off);
    }
#pragma unroll
    for (int nj = 0; nj < 4; nj += 2) {
      unsigned bh[4], bl[4] = {};
      if (DGRAD) {
        const int off = (n0 + nj * 8 + (lane & 7) + (lane >> 4) * 8) *
                            (C::KS + 8) + kk + ((lane >> 3) & 1) * 8;
        ldsm_x4(bh, Bh + off);
        if (MODE != kBf16) ldsm_x4(bl, Bl + off);
      } else {
        const int off = (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * (H + 8) +
                        n0 + nj * 8 + (lane >> 4) * 8;
        ldsm_x4_t(bh, Bh + off);
        if (MODE != kBf16) ldsm_x4_t(bl, Bl + off);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!HH) {
          cross_mma<MODE>(cr[mi][nj], ah[mi], al[mi], bh[0], bh[1], bl[0],
                          bl[1]);
          cross_mma<MODE>(cr[mi][nj + 1], ah[mi], al[mi], bh[2], bh[3],
                          bl[2], bl[3]);
        } else {
          tier_mma_f32<MODE>(hh[mi][nj], cr[mi][nj], ah[mi], al[mi], bh[0],
                             bh[1], bl[0], bl[1]);
          tier_mma_f32<MODE>(hh[mi][nj + 1], cr[mi][nj + 1], ah[mi], al[mi],
                             bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
  }
}

template <int H, bool DGRAD, bool HH>
__device__ __forceinline__ void tc_slab_dispatch(int mode, const bf16* Ah,
                                                 const bf16* Al, int acol0,
                                                 const bf16* Bh,
                                                 const bf16* Bl, int ksteps,
                                                 float (&hh)[2][4][4],
                                                 float (&cr)[2][4][4]) {
  if (mode == kBf16x3)
    tc_slab<H, kBf16x3, DGRAD, HH>(Ah, Al, acol0, Bh, Bl, ksteps, hh, cr);
  else if (mode == kBf16x2)
    tc_slab<H, kBf16x2, DGRAD, HH>(Ah, Al, acol0, Bh, Bl, ksteps, hh, cr);
  else if (HH)  // bf16 has no cross term
    tc_slab<H, kBf16, DGRAD, HH>(Ah, Al, acol0, Bh, Bl, ksteps, hh, cr);
}

// hh += the hi.hi term of one dgrad K-slab as fp32 FMAs in k order, the
// order of the plain version's (and the FMA kernel's) f32 product, for the
// warp's 32 x 32 block: gpre's hi plane from column acol0, W^T's hi slab
// (H x KS, pitch KS + 8).  The products are exact, so every FMA rounds as
// the reference's does.
template <int H>
__device__ __forceinline__ void seq_hh_slab(const bf16* Ah, int acol0,
                                            const bf16* Wh, int kn,
                                            float (&hh)[2][4][4]) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / C::WN) * 32 + (lane >> 2);
  const int c0 = (warp % C::WN) * 32 + (lane & 3) * 2;
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    float x[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        x[mi][half] = __bfloat162float(
            Ah[(r0 + mi * 16 + half * 8) * C::LDB + acol0 + k]);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const bf16* wc = Wh + (c0 + nj * 8) * (C::KS + 8) + k;
      const float w0 = __bfloat162float(wc[0]);
      const float w1 = __bfloat162float(wc[C::KS + 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          hh[mi][nj][half * 2] = fmaf(x[mi][half], w0, hh[mi][nj][half * 2]);
          hh[mi][nj][half * 2 + 1] =
              fmaf(x[mi][half], w1, hh[mi][nj][half * 2 + 1]);
        }
    }
  }
}

// hh and cr += one forward K-slab of every term of the tier as fp32 FMAs in
// k order, the FMA kernel's chains (dense_tile: hi.hi; then hi.lo and, in
// bf16x3, lo.hi interleaved per k).
template <int H, int MODE>
__device__ __forceinline__ void seq_fwd_slab(const bf16* Xh, const bf16* Xl,
                                             int acol0, const bf16* Wh,
                                             const bf16* Wl, int kn,
                                             float (&hh)[2][4][4],
                                             float (&cr)[2][4][4]) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / C::WN) * 32 + (lane >> 2);
  const int c0 = (warp % C::WN) * 32 + (lane & 3) * 2;
#pragma unroll 1
  for (int k = 0; k < kn; ++k) {
    float xh[2][2], xl[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int idx = (r0 + mi * 16 + half * 8) * C::LDB + acol0 + k;
        xh[mi][half] = __bfloat162float(Xh[idx]);
        xl[mi][half] = MODE == kBf16x3 ? __bfloat162float(Xl[idx]) : 0.0f;
      }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const bf162 h2 = *reinterpret_cast<const bf162*>(
          Wh + k * (H + 8) + c0 + nj * 8);
      const bf162 l2 = *reinterpret_cast<const bf162*>(
          Wl + k * (H + 8) + c0 + nj * 8);
      const float wh[2] = {__bfloat162float(h2.x), __bfloat162float(h2.y)};
      const float wl[2] = {__bfloat162float(l2.x), __bfloat162float(l2.y)};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float& h = hh[mi][nj][half * 2 + q];
            float& c = cr[mi][nj][half * 2 + q];
            h = fmaf(xh[mi][half], wh[q], h);
            if (MODE == kBf16x2 || MODE == kBf16x3)
              c = fmaf(xh[mi][half], wl[q], c);
          }
      if (MODE == kBf16x3) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              cr[mi][nj][half * 2 + q] =
                  fmaf(xl[mi][half], wh[q], cr[mi][nj][half * 2 + q]);
      }
    }
  }
}

// Rows [k0, k0 + KS) of a (K x H) bf16 plane pair into a forward slab
// (pitch H + 8); rows at or past K are zero.
template <int H>
__device__ __forceinline__ void issue_fwd_slab(bf16* dh, bf16* dl,
                                               const bf16* sh, const bf16* sl,
                                               int k0, int K) {
  constexpr int VR = H / 8;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < Tc<H>::KS * VR; e += kThreads) {
    const int r = e / VR, v = e % VR;
    const bool ok = k0 + r < K;
    const long long src = ok ? static_cast<long long>(k0 + r) * H + v * 8 : 0;
    const int dst = r * (H + 8) + v * 8;
    cp_async16(dh + dst, sh + src, ok ? 16 : 0);
    cp_async16(dl + dst, sl + src, ok ? 16 : 0);
  }
}

// Columns [c0, c0 + KS) of every row of an (H x H) bf16 plane pair into a
// dgrad slab (H rows, pitch KS + 8).
template <int H>
__device__ __forceinline__ void issue_dgrad_slab(bf16* dh, bf16* dl,
                                                 const bf16* sh,
                                                 const bf16* sl, int c0) {
  constexpr int KS = Tc<H>::KS, VR = KS / 8;
  for (int e = threadIdx.x; e < H * VR; e += kThreads) {
    const int j = e / VR, v = e % VR;
    const long long src = static_cast<long long>(j) * H + c0 + v * 8;
    const int dst = j * (KS + 8) + v * 8;
    cp_async16(dh + dst, sh + src, 16);
    cp_async16(dl + dst, sl + src, 16);
  }
}

// One (TM x H) x (K x H) product (the forward, K = H or 2F rows of W) or
// (TM x H) x (H x H)^T (the dgrad) on the tensor cores, W's planes (global,
// per window) streamed through two slab stages by cp.async.
template <int H, bool DGRAD>
__device__ __forceinline__ void tc_product(int mode, const bf16* Ah,
                                           const bf16* Al, const bf16* wh,
                                           const bf16* wl, int K, bf16* Ws,
                                           float (&hh)[2][4][4],
                                           float (&cr)[2][4][4]) {
  constexpr int KS = Tc<H>::KS, WSP = Tc<H>::WSP;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) hh[mi][nj][q] = cr[mi][nj][q] = 0.0f;
  const int ns = (K + KS - 1) / KS;
  auto issue = [&](int s, int st) {
    bf16* dh = Ws + st * 2 * WSP;
    if (DGRAD)
      issue_dgrad_slab<H>(dh, dh + WSP, wh, wl, s * KS);
    else
      issue_fwd_slab<H>(dh, dh + WSP, wh, wl, s * KS, K);
  };
  __syncthreads();  // A is complete; the slab stages are free
  issue(0, 0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // slab s has landed; slab s - 1 is consumed
    if (s + 1 < ns) issue(s + 1, (s + 1) & 1);
    cp_async_commit();
    const bf16* bh = Ws + (s & 1) * 2 * WSP;
    const int kn = K - s * KS < KS ? K - s * KS : KS;
    if constexpr (SIREN_SWEEP_SEQ == 0) {  // every term on mma
      tc_slab_dispatch<H, DGRAD, true>(mode, Ah, Al, s * KS, bh, bh + WSP,
                                       (kn + 15) / 16, hh, cr);
    } else if constexpr (DGRAD || SIREN_SWEEP_SEQ == 1) {
      // hi.hi in the reference's order, the cross terms on mma
      if constexpr (DGRAD)
        seq_hh_slab<H>(Ah, s * KS, bh, kn, hh);
      else
        seq_fwd_slab<H, kBf16>(Ah, Al, s * KS, bh, bh + WSP, kn, hh, cr);
      tc_slab_dispatch<H, DGRAD, false>(mode, Ah, Al, s * KS, bh, bh + WSP,
                                        (kn + 15) / 16, hh, cr);
    } else if (mode == kBf16x3) {  // every term in the reference's order
      seq_fwd_slab<H, kBf16x3>(Ah, Al, s * KS, bh, bh + WSP, kn, hh, cr);
    } else if (mode == kBf16x2) {
      seq_fwd_slab<H, kBf16x2>(Ah, Al, s * KS, bh, bh + WSP, kn, hh, cr);
    } else {
      seq_fwd_slab<H, kBf16>(Ah, Al, s * KS, bh, bh + WSP, kn, hh, cr);
    }
  }
}

// The warp's accumulators -> pre = (hh + cr) + b, saved to pre_out (TM x H
// f32), and the activation (0 at or past `live`) split into the X planes
// and, as the next layer's x_in for dW, into xg (rows of H: hi, and lo at
// xg + xlo when xlo > 0).
template <int H>
__device__ __forceinline__ void store_tc(const float (&hh)[2][4][4],
                                         const float (&cr)[2][4][4],
                                         const float* sb, const float* sa,
                                         int kind, float omega, int deg,
                                         bf16* Xh, bf16* Xl, float* pre_out,
                                         int live, bf16* xg, long long xlo) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / C::WN) * 32, n0 = (warp % C::WN) * 32;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + mi * 16 + gid + half * 8;
        const int col = n0 + nj * 8 + tig * 2;
        float p[2], v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          p[q] = (hh[mi][nj][half * 2 + q] + cr[mi][nj][half * 2 + q]) +
                 sb[col + q];
          v[q] = col + q < live
                     ? activate(kind, p[q], omega, sa[col + q], deg)
                     : 0.0f;
        }
        *reinterpret_cast<float2*>(pre_out + row * H + col) =
            make_float2(p[0], p[1]);
        bf162 hi, lo;
        split_bf16(v[0], &hi.x, &lo.x);
        split_bf16(v[1], &hi.y, &lo.y);
        *reinterpret_cast<bf162*>(Xh + row * C::LDB + col) = hi;
        *reinterpret_cast<bf162*>(Xl + row * C::LDB + col) = lo;
        if (xg != nullptr) {
          *reinterpret_cast<bf162*>(xg + row * H + col) = hi;
          if (xlo > 0) *reinterpret_cast<bf162*>(xg + xlo + row * H + col) = lo;
        }
      }
}

// The warp's accumulators -> dX = hh + cr (TM x H f32, pitch LDX).
template <int H>
__device__ __forceinline__ void store_dx(const float (&hh)[2][4][4],
                                         const float (&cr)[2][4][4],
                                         float* dX) {
  using C = Tc<H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / C::WN) * 32, n0 = (warp % C::WN) * 32;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + mi * 16 + gid + half * 8;
        const int col = n0 + nj * 8 + tig * 2;
        *reinterpret_cast<float2*>(dX + row * C::LDX + col) = make_float2(
            hh[mi][nj][half * 2] + cr[mi][nj][half * 2],
            hh[mi][nj][half * 2 + 1] + cr[mi][nj][half * 2 + 1]);
      }
}

// Each window's h x h weights (layers 1 .. L-2, then an RFF W0 (2F x h))
// split into packed bf16 hi / lo planes: (k, wq) each, wq = (L - 2) h^2 +
// 2F h.  The w role of every tensor-core product of the step.
__global__ void __launch_bounds__(kThreads)
siren_wsplit_kernel(const float* __restrict__ params, bf16* __restrict__ whi,
                    bf16* __restrict__ wlo, const TrainArgs args, int h,
                    long long wq, int k) {
  const long long hh = static_cast<long long>(h) * h;
  const long long nhh = (args.n_layers - 2) * hh;
  const long long total = wq * k;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long w = e / wq, i = e % wq;
    const long long src =
        i < nhh ? args.off_w[1 + i / hh] + i % hh : args.off_w[0] + (i - nhh);
    split_bf16(params[w * args.P + src], whi + e, wlo + e);
  }
}

// One unit (window, row slice) over the row tiles of chunk `chunk` of its
// slice: forward recompute, cotangent, head, dgrad sweep; dW's operands
// into the unit's planes (local row = row - the chunk's first row).
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
  using C = Tc<H>;
  constexpr int TM = C::TM, LDB = C::LDB, LDX = C::LDX, KS = C::KS;
  constexpr int WSP = C::WSP;
  constexpr int TPR = kThreads / TM;   // head forward: threads per row
  constexpr int TPC = kThreads / H;    // column passes: threads per column
  constexpr int RPT = TM / TPC;        // column passes: rows per thread (32)
  static_assert(RPT % 8 == 0, "rows per thread in chunks of 8");
  extern __shared__ float4 smem4[];
  bf16* Xh = reinterpret_cast<bf16*>(smem4);  // X planes, then G planes
  bf16* Xl = Xh + TM * LDB;
  bf16* Ws = Xl + TM * LDB;                   // [stage][hi, lo][WSP]
  float* dX = reinterpret_cast<float*>(Ws + 4 * WSP);
  float* sb = dX + TM * LDX;
  float* sa = sb + H;
  float* sc = sa + H;
  float* shp = sc + TM * kMaxIn;       // head pre
  float* shg = shp + TM;               // head gpre (f32)
  float* shh = shg + TM;               // head gpre hi
  float* shl = shh + TM;               // head gpre lo
  float* sl = shl + TM;                // per-row loss
  float* red = sl + TM;                // 2 * kThreads column partials

  const int tid = threadIdx.x;
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
  const bf16* wh = whi + win * wq;
  const bf16* wl = wlo + win * wq;
  const long long HH = static_cast<long long>(H) * H;
  float* slab = partial + static_cast<long long>(u) * args.P;
  float* pre_tile = pre_buf + static_cast<long long>(blockIdx.x) * L * kTileFloats;
  bf16* up = planes + blockIdx.x * unit_elems;
  const long long RCH = static_cast<long long>(rows_cap) * H;
  const int npl = tc_x_planes(gm) + tc_g_planes(gm);
  const long long xlo = gm == kBf16x3 ? RCH : 0;  // x_in's lo plane
  const int ec = tid % H, es = tid / H;  // column-pass mapping
  const int n_lim = limit != nullptr ? min(n, __ldg(limit)) : n;

  if (chunk == 0 && tid == 0) {  // zero the pads between leaves of the slab
    for (int li = 0; li < L; ++li) {
      const int in_f = li == 0 ? (F > 0 ? 2 * F : d) : H;
      const int out_f = li == L - 1 ? 1 : H;
      int ends[3] = {args.off_w[li] + in_f * out_f, args.off_b[li] + out_f,
                     args.off_a[li] >= 0 ? args.off_a[li] + out_f : -1};
      for (int q = 0; q < 3; ++q)
        for (int e = ends[q]; e >= 0 && (e & 3); ++e) slab[e] = 0.0f;
    }
  }
  float loss_acc = 0.0f;  // thread 0: the chunk's loss

  for (int t = c0t; t < c1t; ++t) {
    const bool first = t == t_begin;
    const int row0 = t * TM;
    const long long lr0 = static_cast<long long>(t - c0t) * TM;
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
      const int kind = args.kind[0], deg = args.deg[0];
      const float omega = args.omega[0];
      // x_in of layer 1, for dW (none when layer 1 is the head)
      bf16* xg0 = L > 2 ? up + lr0 * H : nullptr;
      if (F > 0) {
        // [cos v, sin v] W0 by K-slabs: the features of the slab into the
        // X planes (the forward tier's split), W0's slab by cp.async
        const int K = 2 * F;
        const bf16* w0h = wh + (L - 2) * HH;
        const bf16* w0l = wl + (L - 2) * HH;
        float hh[2][4][4], cr[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int q = 0; q < 4; ++q) hh[mi][nj][q] = cr[mi][nj][q] = 0.0f;
        for (int k0 = 0; k0 < K; k0 += KS) {
          const int kn = K - k0 < KS ? K - k0 : KS;
          const int kn16 = (kn + 15) & ~15;
          __syncthreads();  // the previous slab is consumed
          issue_fwd_slab<H>(Ws, Ws + WSP, w0h, w0l, k0, K);
          cp_async_commit();
          for (int e = tid; e < TM * kn16; e += kThreads) {
            const int r = e / kn16, j = e % kn16;
            const float v = j < kn ? rff_feature(sc + r * d, args.bt, d, F,
                                                 k0 + j, args.fdeg)
                                   : 0.0f;
            split_bf16(v, Xh + r * LDB + j, Xl + r * LDB + j);
          }
          cp_async_wait<0>();
          __syncthreads();
          tc_slab_dispatch<H, false, true>(args.mode[0], Xh, Xl, 0, Ws,
                                           Ws + WSP, kn16 / 16, hh, cr);
        }
        __syncthreads();  // every warp has read the features
        store_tc<H>(hh, cr, sb, sa, kind, omega, deg, Xh, Xl, pre_tile,
                    args.h_real, xg0, xlo);
      } else {
        const float* w0 = wp + args.off_w[0];
        for (int e = tid; e < d * H; e += kThreads) dX[e] = w0[e];
        __syncthreads();
        for (int e = tid; e < TM * H; e += kThreads) {
          const int r = e / H, c = e % H;
          float pre = sb[c];
          for (int q = 0; q < d; ++q) pre = pre + sc[r * d + q] * dX[q * H + c];
          pre_tile[e] = pre;
          bf16* xh = Xh + r * LDB + c;
          bf16* xl = Xl + r * LDB + c;
          split_bf16(c < args.h_real ? activate(kind, pre, omega, sa[c], deg)
                                     : 0.0f,
                     xh, xl);
          if (xg0 != nullptr) {
            xg0[e] = *xh;
            if (xlo > 0) xg0[xlo + e] = *xl;
          }
        }
      }
    }
    for (int li = 1; li < L - 1; ++li) {
      float hh[2][4][4], cr[2][4][4];
      float nb = 0.0f, na = 1.0f;  // layer li's bias and a, loaded early
      if (tid < H) {
        nb = wp[args.off_b[li] + tid];
        if (args.off_a[li] >= 0) na = wp[args.off_a[li] + tid];
      }
      tc_product<H, false>(args.mode[li], Xh, Xl, wh + (li - 1) * HH,
                           wl + (li - 1) * HH, H, Ws, hh, cr);
      __syncthreads();  // every warp has read X and the bias of layer li-1
      if (tid < H) {
        sb[tid] = nb;
        sa[tid] = na;
      }
      __syncthreads();
      store_tc<H>(hh, cr, sb, sa, args.kind[li], args.omega[li], args.deg[li],
                  Xh, Xl, pre_tile + li * kTileFloats, args.h_real,
                  li + 1 < L - 1 ? up + li * npl * RCH + lr0 * H : nullptr,
                  xlo);
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
      const int r = tid / TPR, s = tid % TPR;
      const bf16* xh = Xh + r * LDB;
      const bf16* xl = Xl + r * LDB;
      float acc = 0.0f, acc2 = 0.0f;
      for (int j = s; j < H; j += TPR) {
        const float xv = __bfloat162float(xh[j]);
        acc = fmaf(xv, dX[j], acc);
        if (mode == kBf16x2 || mode == kBf16x3) acc2 = fmaf(xv, dX[H + j], acc2);
        if (mode == kBf16x3) acc2 = fmaf(__bfloat162float(xl[j]), dX[j], acc2);
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
      loss_acc = t == c0t ? s * args.inv_n : loss_acc + s * args.inv_n;
    }

    // ================= backward =================
    // head: gpre, db, dW (h x 1) from the X planes (the head's input, the
    // grad tier's rounding: hi, and lo in bf16x3), and dX (TM x h)
    {
      const int kind = args.kind[LH];
      const float a = args.off_a[LH] >= 0 ? wp[args.off_a[LH]] : 1.0f;
      for (int r = tid; r < TM; r += kThreads) {
        float ga = 0.0f;
        const float gp = dact(kind, shp[r], args.omega[LH], a, args.deg[LH],
                              shg[r], &ga);
        shg[r] = gp;
        shp[r] = ga;
        wsplit(gp, gm, shh + r, shl + r);
      }
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
      float acc = 0.0f, acc2 = 0.0f;
      for (int r = es; r < TM; r += TPC) {
        const float xh = __bfloat162float(Xh[r * LDB + ec]);
        acc = fmaf(xh, shh[r], acc);
        if (gm == kBf16x2 || gm == kBf16x3) acc2 = fmaf(xh, shl[r], acc2);
        if (gm == kBf16x3)
          acc2 = fmaf(__bfloat162float(Xl[r * LDB + ec]), shh[r], acc2);
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
      float whv, wlv;
      wsplit(wp[args.off_w[LH] + ec], gm, &whv, &wlv);
      for (int r = es; r < TM; r += TPC) {
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
        const float* pt = pre_tile + li * kTileFloats;
        const int kind = args.kind[li], deg = args.deg[li];
        const float omega = args.omega[li];
        const float a = args.off_a[li] >= 0 ? wp[args.off_a[li] + ec] : 1.0f;
        bf16* gph = nullptr;  // the unit's gpre planes of this layer
        if (li > 0)
          gph = up + ((li - 1) * npl + tc_x_planes(gm)) * RCH;
        else if (F > 0)
          gph = up + (L - 2) * npl * RCH;
        float db = 0.0f, da = 0.0f;
        for (int i0 = 0; i0 < RPT; i0 += 8) {
          float pv[8];  // the pres of 8 rows, loaded before any store
#pragma unroll
          for (int i = 0; i < 8; ++i)
            pv[i] = pt[(es + (i0 + i) * TPC) * H + ec];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = es + (i0 + i) * TPC;
            float ga = 0.0f;
            const float gp = dact(kind, pv[i], omega, a, deg,
                                  dX[r * LDX + ec], &ga);
            db += gp;
            da += ga;
            bf16 hi, lo;
            split_bf16(gp, &hi, &lo);
            Xh[r * LDB + ec] = hi;
            Xl[r * LDB + ec] = lo;
            if (gph != nullptr) {
              const long long idx = (lr0 + r) * H + ec;
              gph[idx] = hi;
              if (gm != kBf16) gph[RCH + idx] = lo;
            }
          }
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
      // ---- dX = gpre W^T on the tensor cores ----
      {
        float hh[2][4][4], cr[2][4][4];
        tc_product<H, true>(gm, Xh, Xl, wh + (li - 1) * HH, wl + (li - 1) * HH,
                            H, Ws, hh, cr);
        store_dx<H>(hh, cr, dX);  // dX was last read before the G planes
        __syncthreads();
      }
    }

    // ---- a raw layer 0's dW: coords^T gpre0, rows split over TPC ----
    if (F == 0) {
      __syncthreads();
      float acc[kMaxIn], acc2[kMaxIn];
#pragma unroll
      for (int q = 0; q < kMaxIn; ++q) acc[q] = acc2[q] = 0.0f;
      for (int r = es; r < TM; r += TPC) {
        const float gh = __bfloat162float(Xh[r * LDB + ec]);
        const float gl = __bfloat162float(Xl[r * LDB + ec]);
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
      float* part = dX;  // (TPC, d, H) x 2
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
                 int rows_cap, long long unit_elems, long long wq,
                 cudaStream_t stream) {
  const size_t smem = Tc<H>::smem_bytes();
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
// group's first window, and whi / wlo (k, wq) bf16, wq = (n_layers - 2) h^2
// + 2 n_freq h, hold that group's planes (siren_wsplit).  A unit u = w *
// slices + s is window w's row slice s; partial (k * slices, P) and
// loss_part (k * slices) are indexed by it.  A pass runs units [u0, u0 +
// units) over the tiles of chunk `chunk` of their slices (chunk_tiles
// tiles a chunk); its pre (units, n_layers, 8192) f32 and planes (units,
// unit_elems) bf16 scratch are indexed by u - u0, each unit's planes
// rows_cap rows of h.  wgt: as siren_grad's.  Every call returns a
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
  const long long wq = static_cast<long long>(n_layers - 2) * h * h +
                       2LL * n_freq * h;
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
                long long unit_elems, const void* limit, const void* wgt,
                void* stream) {
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
  const long long wq = static_cast<long long>(n_layers - 2) * h * h +
                       2LL * n_freq * h;
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
                  unit_elems, wq, s)
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
