// Device helpers shared by siren_stack.cu and siren_train.cu: layer and
// tier codes, bf16 splits, the sin/cos of the JAX package (Cody-Waite
// reduction + odd polynomials), the activations, and the tiered (rows x h) @
// (h x h) register tile.  Each .cu file that includes this header is its own
// shared library, so everything here has internal linkage.

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

}  // namespace
