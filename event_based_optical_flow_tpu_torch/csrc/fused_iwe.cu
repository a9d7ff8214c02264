// Fused flow gather + multi-reference-time warp + bilinear vote, and its
// flow gradient, for NVIDIA Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by event_based_optical_flow_tpu_torch/ops/fused_iwe.py.
//
// Replaces the Pallas TPU kernels of the JAX package
//   ops/pallas_objective.py          _fwd_kernel / _bwd_kernel
//                                    (fused_multi_iwe, custom-VJP backward)
//   ops/pallas_objective_banded.py   _fwd_kernel+_fwd_one_chunk /
//                                    _bwd_kernel+_bwd_one_chunk
//                                    (fused_multi_iwe_banded, its backward)
// Both TPU layouts compute one contract; this file computes it once, on
// unpacked events (no band/tile packing, row windows or bf16 splits: those
// fed the TPU's matrix unit and are not part of the contract).
//
// Forward, per event i with weight wt (wt == 0 marks a padded event):
//   gather   u, v = flow[:, (int)x, (int)y]   -- TRUNCATION toward zero, the
//            Pallas _onehot_int rule; a truncated index outside [0,H)x[0,W)
//            reads 0 (zero-padded flow), it is NOT clipped as the XLA warp
//            path does.  The two agree for in-image events.
//   warp     per offset o: xw = x - (dtf - o) u,  yw = y - (dtf - o) v
//   vote     fl = floor(c + eps), frac = c - fl (not c + eps - fl);
//            wt*(1-fx)(1-fy), wt*fx(1-fy), wt*(1-fx)fy, wt*fx*fy into the
//            four corners; corners outside the image are dropped.
//   orig     with include_orig, image 0 is the unwarped vote.
// The votes are computed in T and accumulated as 64-bit fixed point in
// units of 2^-kFixBits with integer atomicAdd, then converted to T by a
// second kernel.  Integer addition is associative, so the images are the
// same bits whatever order the atomics land in: the forward is
// reproducible from run to run.  A float32 vote of magnitude >= 2^-13 is
// converted exactly; the sum overflows only past 2^(63-kFixBits) weight
// units in one pixel (the wrapper bounds the event count).
// Backward, given the image cotangent g [K, H, W]:
//   d/dxw = wt * sum over the 4 corners of g * (one-sided corner
//   derivative: -1 at fl, +1 at fl+1) * (the other axis' corner weight),
//   likewise d/dyw; du += -(dtf-o) d/dxw, dv += -(dtf-o) d/dyw over the
//   offsets (the orig image has no flow dependence); du, dv go to
//   dflow[:, (int)x, (int)y].  x, y, dtf and wt get no gradient.
// One kernel writes each event's du, dv; a second one, in the first event
// of each run of consecutive events with one source pixel, sums the run in
// index order and adds it to that pixel with one atomicAdd.  With the
// events sorted by source pixel (FrameEvents sorts them) every pixel gets
// exactly one add, onto zero, so dflow is reproducible from run to run
// too; unsorted events give the same sum up to the order of a few adds.
//
// What bounds it on the H100: scattered 8-byte integer atomic adds and
// gathers — per event per offset 4 atomics forward, 4 gathers of g
// backward — not FLOPs (a few dozen per event).  Nothing is staged in
// shared memory yet; one thread per event in grid-stride loops (and one
// per run head for the backward's sums).
//
// Build with -fmad=false: the warped coordinates then round exactly like
// PyTorch's separate elementwise ops in the plain version, so both make the
// same floor decisions and differ only by summation order (and, in
// float64, by the fixed-point unit: at most 2^-37 per vote).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxOffsets = 8;
constexpr int kThreads = 256;
constexpr int kFixBits = 36;
constexpr double kFixScale = 68719476736.0;           // 2^36
constexpr double kFixUnit = 1.0 / 68719476736.0;      // 2^-36
static_assert(kFixScale == static_cast<double>(1ull << kFixBits), "kFixScale is 2^kFixBits");

template <typename T>
struct Offsets {
  T v[kMaxOffsets];
  int n;
};

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

template <typename T>
__device__ __forceinline__ void vote(unsigned long long* img, T xw, T yw, T wt, T eps, int H,
                                     int W) {
  int r0, c0;
  T fx, fy;
  if (!corners(xw, yw, eps, H, W, &r0, &c0, &fx, &fy)) return;
  const bool in_r0 = r0 >= 0, in_r1 = r0 + 1 < H;
  const bool in_c0 = c0 >= 0, in_c1 = c0 + 1 < W;
  if (in_r0 && in_c0) add_fixed(img + r0 * W + c0, (T(1) - fx) * (T(1) - fy) * wt);
  if (in_r1 && in_c0) add_fixed(img + (r0 + 1) * W + c0, fx * (T(1) - fy) * wt);
  if (in_r0 && in_c1) add_fixed(img + r0 * W + c0 + 1, (T(1) - fx) * fy * wt);
  if (in_r1 && in_c1) add_fixed(img + (r0 + 1) * W + c0 + 1, fx * fy * wt);
}

// Flow index of an event's source pixel by truncation, or -1 outside.
template <typename T>
__device__ __forceinline__ int source_pixel(T x, T y, int H, int W) {
  if (!(x > T(-1) && x < T(H) && y > T(-1) && y < T(W))) return -1;
  return static_cast<int>(x) * W + static_cast<int>(y);
}

template <typename T>
__global__ void fused_iwe_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     int n, const T* __restrict__ flow, Offsets<T> offs,
                                     int include_orig, int H, int W, T eps,
                                     unsigned long long* __restrict__ acc) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T w = wt[i];
    if (w == T(0)) continue;
    const T xi = x[i], yi = y[i];
    int k0 = 0;
    if (include_orig) {
      vote(acc, xi, yi, w, eps, H, W);
      k0 = 1;
    }
    if (offs.n == 0) continue;
    const int p = source_pixel(xi, yi, H, W);
    const T u = p >= 0 ? flow[p] : T(0);
    const T v = p >= 0 ? flow[hw + p] : T(0);
    const T d = dtf[i];
    for (int k = 0; k < offs.n; ++k) {
      const T dt = d - offs.v[k];
      const T xw = xi - dt * u;
      const T yw = yi - dt * v;
      vote(acc + (k0 + k) * hw, xw, yw, w, eps, H, W);
    }
  }
}

template <typename T>
__global__ void from_fixed_kernel(const long long* __restrict__ acc, int n, T* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = static_cast<T>(static_cast<double>(acc[i]) * kFixUnit);
  }
}

template <typename T>
__device__ __forceinline__ T g_at(const T* g, int r, int c, int H, int W) {
  return (r >= 0 && r < H && c >= 0 && c < W) ? g[r * W + c] : T(0);
}

// du, dv of one event (summed over the offsets).
template <typename T>
__device__ __forceinline__ void event_grad(T xi, T yi, T d, T w, T u, T v, const Offsets<T>& offs,
                                           int k0, int H, int W, T eps, const T* g, T* du,
                                           T* dv) {
  const int hw = H * W;
  for (int k = 0; k < offs.n; ++k) {
    const T dt = d - offs.v[k];
    const T xw = xi - dt * u;
    const T yw = yi - dt * v;
    int r0, c0;
    T fx, fy;
    if (!corners(xw, yw, eps, H, W, &r0, &c0, &fx, &fy)) continue;
    const T* gk = g + (k0 + k) * hw;
    const T g00 = g_at(gk, r0, c0, H, W);
    const T g10 = g_at(gk, r0 + 1, c0, H, W);
    const T g01 = g_at(gk, r0, c0 + 1, H, W);
    const T g11 = g_at(gk, r0 + 1, c0 + 1, H, W);
    const T dxw = w * (((T(1) - fy) * g10 + fy * g11) - ((T(1) - fy) * g00 + fy * g01));
    const T dyw = w * ((T(1) - fx) * (g01 - g00) + fx * (g11 - g10));
    *du += -dt * dxw;
    *dv += -dt * dyw;
  }
}

// Backward, step 1: one thread per event writes its du, dv (summed over
// the offsets) to duv [2, n]; padded events and events whose source pixel
// is outside the flow write 0.
template <typename T>
__global__ void fused_iwe_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     int n, const T* __restrict__ flow, Offsets<T> offs,
                                     int include_orig, int H, int W, T eps,
                                     const T* __restrict__ g, T* __restrict__ duv) {
  const int hw = H * W;
  const int k0 = include_orig ? 1 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T xi = x[i], yi = y[i], w = wt[i];
    const int p = source_pixel(xi, yi, H, W);
    T du = T(0), dv = T(0);
    if (p >= 0 && w != T(0)) {
      event_grad(xi, yi, dtf[i], w, flow[p], flow[hw + p], offs, k0, H, W, eps, g, &du, &dv);
    }
    duv[i] = du;
    duv[n + i] = dv;
  }
}

// Backward, step 2: the first event of each run of consecutive events with
// one source pixel sums the run's du, dv in index order and adds the sums
// to that pixel.
template <typename T>
__global__ void fused_iwe_bwd_sum_kernel(const T* __restrict__ x, const T* __restrict__ y, int n,
                                         int H, int W, const T* __restrict__ duv,
                                         T* __restrict__ dflow) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int p = source_pixel(x[i], y[i], H, W);
    if (p < 0) continue;  // the gradient's target pixel is outside the flow
    if (i > 0 && source_pixel(x[i - 1], y[i - 1], H, W) == p) continue;  // not a run head
    T du = T(0), dv = T(0);
    for (int j = i; j < n && source_pixel(x[j], y[j], H, W) == p; ++j) {
      du += duv[j];
      dv += duv[n + j];
    }
    atomicAdd(dflow + p, du);
    atomicAdd(dflow + hw + p, dv);
  }
}

template <typename T>
Offsets<T> make_offsets(const double* offsets, int n_off) {
  Offsets<T> o;
  o.n = n_off;
  for (int k = 0; k < kMaxOffsets; ++k) o.v[k] = k < n_off ? static_cast<T>(offsets[k]) : T(0);
  return o;
}

int grid_for(int n) {
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  return blocks;
}

// acc: zeroed int64 scratch of the out's size.
template <typename T>
int launch_fwd(const T* x, const T* y, const T* dtf, const T* wt, int n, const T* flow,
               const double* offsets, int n_off, int include_orig, int H, int W,
               double eps, long long* acc, T* out, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_iwe_fwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, n, flow, make_offsets<T>(offsets, n_off), include_orig, H, W,
        static_cast<T>(eps), reinterpret_cast<unsigned long long*>(acc));
  }
  const int n_out = (n_off + (include_orig ? 1 : 0)) * H * W;
  if (n_out > 0) from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// duv: scratch of 2 * n elements; dflow: zeroed.
template <typename T>
int launch_bwd(const T* x, const T* y, const T* dtf, const T* wt, int n, const T* flow,
               const double* offsets, int n_off, int include_orig, int H, int W,
               double eps, const T* g, T* duv, T* dflow, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && n_off > 0) {
    fused_iwe_bwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, n, flow, make_offsets<T>(offsets, n_off), include_orig, H, W,
        static_cast<T>(eps), g, duv);
    fused_iwe_bwd_sum_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, y, n, H, W, duv, dflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int evflow_max_offsets() { return kMaxOffsets; }

int evflow_fused_iwe_fwd_f32(const float* x, const float* y, const float* dtf, const float* wt,
                             int n, const float* flow, const double* offsets, int n_off,
                             int include_orig, int H, int W, double eps, long long* acc,
                             float* out, void* stream) {
  return launch_fwd<float>(x, y, dtf, wt, n, flow, offsets, n_off, include_orig, H, W, eps,
                           acc, out, stream);
}

int evflow_fused_iwe_fwd_f64(const double* x, const double* y, const double* dtf,
                             const double* wt, int n, const double* flow, const double* offsets,
                             int n_off, int include_orig, int H, int W, double eps, long long* acc,
                             double* out, void* stream) {
  return launch_fwd<double>(x, y, dtf, wt, n, flow, offsets, n_off, include_orig, H, W, eps,
                            acc, out, stream);
}

int evflow_fused_iwe_bwd_f32(const float* x, const float* y, const float* dtf, const float* wt,
                             int n, const float* flow, const double* offsets, int n_off,
                             int include_orig, int H, int W, double eps, const float* g, float* duv,
                             float* dflow, void* stream) {
  return launch_bwd<float>(x, y, dtf, wt, n, flow, offsets, n_off, include_orig, H, W, eps, g, duv,
                           dflow, stream);
}

int evflow_fused_iwe_bwd_f64(const double* x, const double* y, const double* dtf,
                             const double* wt, int n, const double* flow, const double* offsets,
                             int n_off, int include_orig, int H, int W, double eps,
                             const double* g, double* duv, double* dflow, void* stream) {
  return launch_bwd<double>(x, y, dtf, wt, n, flow, offsets, n_off, include_orig, H, W, eps, g, duv,
                            dflow, stream);
}

}  // extern "C"
