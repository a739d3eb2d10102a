// Device helpers shared by siren_stack.cu and siren_train.cu: layer and
// tier codes, bf16 splits, the sin/cos of the JAX package (Cody-Waite
// reduction + odd polynomials), the activations, the RFF features of layer
// 0, and the tiered (rows x K-slab) @ (K-slab x h) register tile.  Each .cu
// file that includes this header is its own shared library, so everything
// here has internal linkage.

#pragma once

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

// Layer 0's RFF feature f (0 <= f < 2F) of one row x[0..d): v = x . 2 pi
// B^T[:, f mod F] as exact f32 multiply-adds in the JAX package's order
// (v = x0 b0, then v = v + xq bq), then cos v for f < F and sin v above.
__device__ __forceinline__ float rff_feature(const float* x,
                                             const float* __restrict__ bt,
                                             int d, int F, int f, int deg) {
  const int col = f < F ? f : f - F;
  float v = x[0] * __ldg(bt + col);
  for (int q = 1; q < d; ++q) v = v + x[q] * __ldg(bt + q * F + col);
  return f < F ? trig_cos(v, deg) : trig_sin(v, deg);
}

// acc[i][c] (+ acc2) += X[r0 + i, 0:kn] . W[0:kn, col(c)] in the given
// tier, over one K-slab: X points at the slab's first column of a
// (rows, H + 4) plane, W at the slab's first row of an (kn, H) plane;
// kn % 4 == 0.  Columns: c0 + 0..3 and c1 + 0..3.  The accumulators carry
// from slab to slab, so the sum runs over j in order whatever the slabs.
template <int H, int MODE>
__device__ __forceinline__ void dense_tile(const float* Xhi, const float* Xlo,
                                           const float* Whi, const float* Wlo,
                                           int r0, int c0, int c1,
                                           float (&acc)[4][8],
                                           float (&acc2)[4][8], int kn) {
  constexpr int LD = H + 4;
#pragma unroll 1
  for (int j = 0; j < kn; j += 4) {
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
__device__ __forceinline__ void dense_dispatch(int mode, const float* Xhi,
                                               const float* Xlo,
                                               const float* Whi,
                                               const float* Wlo, int r0,
                                               int c0, int c1,
                                               float (&acc)[4][8],
                                               float (&acc2)[4][8], int kn) {
  if (mode == kBf16x3)
    dense_tile<H, kBf16x3>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2, kn);
  else if (mode == kBf16x2)
    dense_tile<H, kBf16x2>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2, kn);
  else if (mode == kBf16)
    dense_tile<H, kBf16>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2, kn);
  else
    dense_tile<H, kHighest>(Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2, kn);
}

template <int H>
__host__ __device__ constexpr int tile_rows() { return 8192 / H; }

// Rows of W per shared-memory K-slab: the whole matrix up to h = 128.  At
// h = 256 one W's hi/lo planes (512 KB) exceed the 227 KB a block may use,
// so W streams in 64-row slabs (128 KB for both planes) while the
// accumulators stay in registers.  RFF layer 0's (2F, h) W and its
// features go by slabs of the same size at every width.
template <int H>
__host__ __device__ constexpr int slab_rows() { return H <= 128 ? H : 64; }

// Zero rows [kn, kn4) of a slab's hi/lo planes (an RFF slab's ragged end:
// the matching features are zero too, so the padded products add +0).
template <int H>
__device__ __forceinline__ void zero_slab_tail(float* hi, float* lo, int kn,
                                               int kn4) {
  for (int e = kn * H + threadIdx.x; e < kn4 * H; e += kThreads) {
    hi[e] = 0.0f;
    lo[e] = 0.0f;
  }
}

// pre = (acc + acc2) + b for the thread's register tile, activated and
// written into the X planes in the next layer's tier (the caller has
// synchronised after the last read of X).  With pre_out, pre also goes to
// pre_out[(pre_row0 + row) * H + col] for the rows below pre_rows.
template <int H>
__device__ __forceinline__ void store_tile(const float (&acc)[4][8],
                                           const float (&acc2)[4][8],
                                           const float* sb, const float* sa,
                                           int kind, float omega, int deg,
                                           int next, float* Xhi, float* Xlo,
                                           int r0, int c0, int c1,
                                           float* pre_out, int pre_row0,
                                           int pre_rows, int live = H) {
  constexpr int LD = H + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cb = half ? c1 : c0;
      float p[4], v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = half * 4 + q;
        p[q] = (acc[i][c] + acc2[i][c]) + sb[cb + q];
        // units at or past `live` (a model padded to the kernel width)
        // output exactly 0
        v[q] = cb + q < live ? activate(kind, p[q], omega, sa[cb + q], deg)
                             : 0.0f;
      }
      if (pre_out != nullptr && pre_row0 + r0 + i < pre_rows)
        *reinterpret_cast<float4*>(pre_out + (long long)(pre_row0 + r0 + i) * H +
                                   cb) = make_float4(p[0], p[1], p[2], p[3]);
      const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
      const float4 h4 = split4_hi(v4, next);
      const int idx = (r0 + i) * LD + cb;
      *reinterpret_cast<float4*>(Xhi + idx) = h4;
      if (next != kHighest)
        *reinterpret_cast<float4*>(Xlo + idx) = split4_hi(sub4(v4, h4), kBf16);
    }
  }
}

// Multiply-add the K-slabs of RFF layer 0 into acc / acc2: for each slab of
// W0's 2F rows, its features (from the tile's coordinates sc, TM x d) are
// computed into the X planes, split in the layer's tier, and multiplied by
// the slab of W0 (global, 16-byte aligned).  The (rows, 2F) features never
// reach device memory.  The X planes hold garbage afterwards.
template <int H>
__device__ __forceinline__ void rff_layer0(const float* __restrict__ w0,
                                           const float* __restrict__ bt,
                                           const float* sc, int d, int F,
                                           int fdeg, int mode, float* Whi,
                                           float* Wlo, float* Xhi, float* Xlo,
                                           int r0, int c0, int c1,
                                           float (&acc)[4][8],
                                           float (&acc2)[4][8]) {
  constexpr int TM = tile_rows<H>();
  constexpr int LD = H + 4;
  constexpr int KS = slab_rows<H>();
  const int K = 2 * F;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int kn = K - k0 < KS ? K - k0 : KS;
    const int kn4 = (kn + 3) & ~3;
    __syncthreads();  // the previous slab's planes are consumed
    load_split(w0 + static_cast<long long>(k0) * H, Whi, Wlo, kn * H, mode);
    zero_slab_tail<H>(Whi, Wlo, kn, kn4);
    for (int e = threadIdx.x; e < TM * kn4; e += kThreads) {
      const int r = e / kn4, j = e % kn4;
      const float v = j < kn ? rff_feature(sc + r * d, bt, d, F, k0 + j, fdeg)
                             : 0.0f;
      split_store(v, mode, Xhi, Xlo, r * LD + j);
    }
    __syncthreads();
    dense_dispatch<H>(mode, Xhi, Xlo, Whi, Wlo, r0, c0, c1, acc, acc2, kn4);
  }
}

}  // namespace
