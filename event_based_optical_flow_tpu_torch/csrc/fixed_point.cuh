// The bilinear vote in 64-bit fixed point, shared by csrc/fused_iwe.cu
// (K1-K7, the votes of warped events) and csrc/vote.cu (K8, the standalone
// vote): corners at floor(c + eps) and +1, weights w(1-fx)(1-fy), w fx(1-fy),
// w(1-fx)fy, w fx fy with fx = c - floor(c + eps), corners outside the image
// dropped.  The count vote (iwe.method: count) adds w at each corner that
// lands in the image instead.  An image with an outer padding of p pixels a
// side is (H + 2p) x (W + 2p) and votes at c + p (padded(): c itself when p
// is 0, so an unpadded vote keeps its bits).  Each vote is rounded to a unit of 2^-kFixBits and added to an
// int64 with an integer atomicAdd; a second kernel converts the sums.
// Integer addition is associative, so the images are the same bits whatever
// order the atomics land in.  A float32 vote of magnitude >= 2^-13 is
// converted exactly; a pixel's sum overflows only past 2^(63-kFixBits)
// weight units (each wrapper bounds the events per image).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFixBits = 36;
constexpr double kFixScale = 68719476736.0;           // 2^36
constexpr double kFixUnit = 1.0 / 68719476736.0;      // 2^-36
static_assert(kFixScale == static_cast<double>(1ull << kFixBits), "kFixScale is 2^kFixBits");

template <typename T>
__device__ __forceinline__ T floor_t(T v);
template <>
__device__ __forceinline__ float floor_t<float>(float v) { return floorf(v); }
template <>
__device__ __forceinline__ double floor_t<double>(double v) { return floor(v); }

// Corner decomposition of one warped position.  Returns false when no
// corner can land in the image (or the position is NaN).
template <typename T>
__device__ __forceinline__ bool corners(T xw, T yw, T eps, int H, int W,
                                        int* r0, int* c0, T* fx, T* fy) {
  T flx = floor_t<T>(xw + eps);
  T fly = floor_t<T>(yw + eps);
  if (!(flx >= T(-1) && flx <= T(H - 1) && fly >= T(-1) && fly <= T(W - 1))) {
    return false;
  }
  *r0 = static_cast<int>(flx);
  *c0 = static_cast<int>(fly);
  *fx = xw - flx;
  *fy = yw - fly;
  return true;
}

// Adds one vote, rounded to the fixed-point unit (two's complement, so
// negative weights wrap correctly in the unsigned atomic).
template <typename T>
__device__ __forceinline__ void add_fixed(unsigned long long* acc, T value) {
  const long long q = __double2ll_rn(static_cast<double>(value) * kFixScale);
  atomicAdd(acc, static_cast<unsigned long long>(q));
}

// A coordinate shifted by the image's outer padding.
template <typename T>
__device__ __forceinline__ T padded(T c, int pad) {
  return pad ? c + static_cast<T>(pad) : c;
}

// count: the count vote (w at each corner), else the bilinear one.
template <typename T>
__device__ __forceinline__ void vote(unsigned long long* img, T xw, T yw, T wt, T eps, int H,
                                     int W, bool count = false) {
  int r0, c0;
  T fx, fy;
  if (!corners(xw, yw, eps, H, W, &r0, &c0, &fx, &fy)) return;
  const bool in_r0 = r0 >= 0, in_r1 = r0 + 1 < H;
  const bool in_c0 = c0 >= 0, in_c1 = c0 + 1 < W;
  if (in_r0 && in_c0) add_fixed(img + r0 * W + c0, count ? wt : (T(1) - fx) * (T(1) - fy) * wt);
  if (in_r1 && in_c0) add_fixed(img + (r0 + 1) * W + c0, count ? wt : fx * (T(1) - fy) * wt);
  if (in_r0 && in_c1) add_fixed(img + r0 * W + c0 + 1, count ? wt : (T(1) - fx) * fy * wt);
  if (in_r1 && in_c1) add_fixed(img + (r0 + 1) * W + c0 + 1, count ? wt : fx * fy * wt);
}

template <typename T>
__global__ void from_fixed_kernel(const long long* __restrict__ acc, int n, T* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = static_cast<T>(static_cast<double>(acc[i]) * kFixUnit);
  }
}

int grid_for(int n) {
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  return blocks;
}

}  // namespace
