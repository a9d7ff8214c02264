// Fused flow gather + multi-reference-time warp + bilinear vote, its flow
// gradient, its tangent along a flow direction and the second-order
// backward of the analytic HVP, for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by event_based_optical_flow_tpu_torch/ops/fused_iwe.py.
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
// second kernel (the helpers in fixed_point.cuh, shared with vote.cu, K8).  Integer addition is associative, so the images are the
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
//
// Second order (the analytic Gauss-Newton HVP), replacing
//   ops/pallas_objective_banded.py   _jvp_kernel     (fused_multi_iwe_banded_jvp)
//                                    _hvp_bwd_kernel (fused_multi_iwe_banded_hvp_bwd)
// JVP (K3), given a tangent flow dflow: per event the tangent flow du, dv is
// gathered at the same truncated source pixel (zero outside), the warped
// position moves by dxw = -(dt du), dyw = -(dt dv), and each corner weight's
// directional derivative, e.g. ((-dxw)(1-fy) + (1-fx)(-dyw)) wt at (fl, cl),
// is voted into the tangent image.  With emit_value the value images are
// voted too, by K1's own code into K1's accumulator: they are K1's bits.
// A tangent's scale follows the CG direction, so K1's fixed 2^-36 unit
// could overflow or lose its digits.  The tangent images are summed in 64-bit
// fixed point with a unit chosen per frame on the device: one pass takes
// b = max over the frame's events of |wt| max_k|dtf - o_k| (|du| + |dv|) (an
// integer atomicMax on the bits of a non-negative double: order-free), and
// the unit is the power of two 2^-s with 2 N b 2^s < 2^62 (N the frame's
// events; the factor 2 covers the corner weights' eps slack), so no pixel's
// sum can overflow and every vote keeps ~2^-(60 - log2 N) of b.  No host
// sync: the vote and conversion kernels read b themselves.  A non-finite b (a NaN or inf
// tangent) gives NaN tangent images.  Integer sums again make the tangent
// the same bits on every run.
// HVP backward (K4), given the cost cotangent g1 and its directional
// derivative g2 [K, H, W]: per event
//   term B   K2's du, dv against g2 (the same code: with term A off this is
//            fused_iwe_bwd(g2) bit for bit);
//   term A   s = wt (g1[fl,cl] - g1[fl,cl+1] - g1[fl+1,cl] + g1[fl+1,cl+1])
//            (the vote's mixed second derivative against g1),
//            du += dt^2 s dv_g,  dv += dt^2 s du_g,
// per offset, then K2's ordered run sums onto the source pixel.
// Both are bound like K1/K2 (scattered int64 atomics and gathers); K4 reads
// g1 only with term A.
//
// Time-aware voxels (K5, K6), replacing
//   ops/pallas_objective_banded.py   _vox_fwd_impl / _vox_vjp_bwd
//                                    (fused_multi_iwe_banded_voxel, its backward)
//                                    fused_multi_iwe_banded_voxel_jvp
//                                    fused_multi_iwe_banded_voxel_hvp_bwd
// Every kernel above takes an optional per-event time bin (bins, int32,
// n_bins > 0; bins == nullptr is the dense flow).  The flow and the tangent
// flow are then voxels [n_bins, 2, H, W] and each event reads its (u, v)
// and (du, dv) from its bin's slice, at the same truncated source pixel,
// zero outside the image; a bin outside [0, n_bins) is clamped into it, as
// the TPU packer clips it.  The TPU kernels grid over (bin, chunk) with one
// bin slice resident; here the bin is only an offset of the gather, so the
// votes, the tangent unit and K4's term A are unchanged.  The backward's
// ordered run sums are keyed by (bin, source pixel) over events sorted by
// (bin, source pixel) (FrameEvents sorts them so when time-aware) and write
// the per-bin gradient [n_bins, 2, H, W].  With one bin and every event in
// it the voxel kernels give the dense kernels' bits.
//
// Batches of frames (K7 and K9), replacing
//   ops/pallas_objective_banded.py   _fwd_impl_batched / _vjp_bwd_b,
//                                    _vox_fwd_impl_batched / _vox_vjp_bwd_b,
//                                    fused_multi_iwe_banded_jvp_batched,
//                                    fused_multi_iwe_banded_hvp_bwd_batched,
//                                    fused_multi_iwe_banded_voxel_jvp_batched,
//                                    fused_multi_iwe_banded_voxel_hvp_bwd_batched
//   ops/pallas_objective_batched.py  _fwd_impl_batched / _vjp_bwd (the same
//                                    contract on unpacked events)
// Every kernel above takes an optional frame table (frame_ptr, int32
// [n_frames + 1]; nullptr is one frame of all n events): frame b's events
// are [frame_ptr[b], frame_ptr[b + 1]), the frames concatenated in order.
// An event finds its frame by a binary search of the table, gathers from
// slice frame * T + bin of the flow [B, (T,) 2, H, W] (T = 1 dense) and
// votes into block frame of the images [B, (orig) + K, H, W]; cotangents
// and tangents are read from the same blocks.  The backward's run keys are
// (frame * T + bin) * H * W + pixel over events sorted by (frame, bin,
// pixel) (FleetEvents concatenates frames sorted so).  K3's bound and unit
// are per frame: one bound per frame, and the unit from that frame's own
// event count.  So frame b's outputs are, bit for bit, the single-frame
// kernels' on frame b's events alone: the fixed-point sums and the ordered
// run sums see the same terms, and a frame never reads another's unit.
// The TPU grids over (frame, chunk); here the frame is an offset, as the
// time bin is.

#include "fixed_point.cuh"

namespace {

constexpr int kMaxOffsets = 8;

template <typename T>
struct Offsets {
  T v[kMaxOffsets];
  int n;
};

// Flow index of an event's source pixel by truncation, or -1 outside.
template <typename T>
__device__ __forceinline__ int source_pixel(T x, T y, int H, int W) {
  if (!(x > T(-1) && x < T(H) && y > T(-1) && y < T(W))) return -1;
  return static_cast<int>(x) * W + static_cast<int>(y);
}

// Event i's time bin, clamped into [0, n_bins); 0 for a dense flow.
__device__ __forceinline__ int bin_of(const int* bins, int n_bins, int i) {
  if (bins == nullptr) return 0;
  const int b = bins[i];
  return b < 0 ? 0 : (b >= n_bins ? n_bins - 1 : b);
}

// The frames of a call: frame b holds events [ptr[b], ptr[b + 1]); ptr ==
// nullptr (n == 1) is one frame of every event.
struct Frames {
  const int* ptr;
  int n;
};

// Event i's frame: the last b with ptr[b] <= i (ptr[0] == 0), which skips
// empty frames.
__device__ __forceinline__ int frame_of(Frames fr, int i) {
  if (fr.ptr == nullptr) return 0;
  int lo = 0, hi = fr.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (fr.ptr[mid] <= i) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Frame f's event count; n for one frame.
__device__ __forceinline__ int frame_events(Frames fr, int f, int n) {
  return fr.ptr == nullptr ? n : fr.ptr[f + 1] - fr.ptr[f];
}

// Index of event i (of frame f) into the flow's [B * T] slices of [2, H, W].
__device__ __forceinline__ int slab_of(int f, const int* bins, int n_bins, int i) {
  return f * (n_bins > 0 ? n_bins : 1) + bin_of(bins, n_bins, i);
}

// The backward's run key: (frame * T + bin) * H * W + source pixel, or -1
// outside.
template <typename T>
__device__ __forceinline__ int run_key(const T* x, const T* y, const int* bins, int n_bins, Frames fr,
                                       int i, int H, int W) {
  const int p = source_pixel(x[i], y[i], H, W);
  return p < 0 ? -1 : slab_of(frame_of(fr, i), bins, n_bins, i) * H * W + p;
}

template <typename T>
__global__ void fused_iwe_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     const int* __restrict__ bins, int n_bins, Frames fr,
                                     int n, const T* __restrict__ flow, Offsets<T> offs,
                                     int include_orig, int H, int W, T eps,
                                     unsigned long long* __restrict__ acc) {
  const int hw = H * W;
  const int k0 = include_orig ? 1 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T w = wt[i];
    if (w == T(0)) continue;
    const int f = frame_of(fr, i);
    unsigned long long* img = acc + f * (k0 + offs.n) * hw;  // the frame's image block
    const T xi = x[i], yi = y[i];
    if (include_orig) vote(img, xi, yi, w, eps, H, W);
    if (offs.n == 0) continue;
    const int p = source_pixel(xi, yi, H, W);
    const T* fl = flow + 2 * hw * slab_of(f, bins, n_bins, i);
    const T u = p >= 0 ? fl[p] : T(0);
    const T v = p >= 0 ? fl[hw + p] : T(0);
    const T d = dtf[i];
    for (int k = 0; k < offs.n; ++k) {
      const T dt = d - offs.v[k];
      const T xw = xi - dt * u;
      const T yw = yi - dt * v;
      vote(img + (k0 + k) * hw, xw, yw, w, eps, H, W);
    }
  }
}

template <typename T>
__device__ __forceinline__ T g_at(const T* g, int r, int c, int H, int W) {
  return (r >= 0 && r < H && c >= 0 && c < W) ? g[r * W + c] : T(0);
}

// du, dv of one event (summed over the offsets) against the cotangent g;
// with TermA also the vote's mixed second derivative against g1 along the
// tangent flow (du_g, dv_g) gathered at the event's source pixel (K4).
template <typename T, bool TermA>
__device__ __forceinline__ void event_grad(T xi, T yi, T d, T w, T u, T v, const Offsets<T>& offs,
                                           int k0, int H, int W, T eps, const T* g, const T* g1,
                                           T du_g, T dv_g, T* du, T* dv) {
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
    if constexpr (TermA) {
      const T* hk = g1 + k * hw;
      const T s = w * ((g_at(hk, r0, c0, H, W) - g_at(hk, r0, c0 + 1, H, W)) -
                       (g_at(hk, r0 + 1, c0, H, W) - g_at(hk, r0 + 1, c0 + 1, H, W)));
      *du += dt * dt * s * dv_g;
      *dv += dt * dt * s * du_g;
    }
  }
}

// Backward, step 1: one thread per event writes its du, dv (summed over
// the offsets) to duv [2, n]; padded events and events whose source pixel
// is outside the flow write 0.
template <typename T>
__global__ void fused_iwe_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     const int* __restrict__ bins, int n_bins, Frames fr,
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
      const int f = frame_of(fr, i);
      const T* fl = flow + 2 * hw * slab_of(f, bins, n_bins, i);
      event_grad<T, false>(xi, yi, dtf[i], w, fl[p], fl[hw + p], offs, k0, H, W, eps,
                           g + f * (k0 + offs.n) * hw, nullptr, T(0), T(0), &du, &dv);
    }
    duv[i] = du;
    duv[n + i] = dv;
  }
}

// K4, step 1: as fused_iwe_bwd_kernel against g2 (no orig image), plus term
// A against g1 when TermA.  Step 2 is fused_iwe_bwd_sum_kernel.
template <typename T, bool TermA>
__global__ void fused_iwe_hvp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                         const T* __restrict__ dtf, const T* __restrict__ wt,
                                         const int* __restrict__ bins, int n_bins, Frames fr,
                                         int n, const T* __restrict__ flow,
                                         const T* __restrict__ dflow, Offsets<T> offs, int H,
                                         int W, T eps, const T* __restrict__ g1,
                                         const T* __restrict__ g2, T* __restrict__ duv) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T xi = x[i], yi = y[i], w = wt[i];
    const int p = source_pixel(xi, yi, H, W);
    T du = T(0), dv = T(0);
    if (p >= 0 && w != T(0)) {
      const int f = frame_of(fr, i);
      const int off = 2 * hw * slab_of(f, bins, n_bins, i);
      const int g_off = f * offs.n * hw;  // the frame's cotangent block
      const T du_g = TermA ? dflow[off + p] : T(0);
      const T dv_g = TermA ? dflow[off + hw + p] : T(0);
      event_grad<T, TermA>(xi, yi, dtf[i], w, flow[off + p], flow[off + hw + p], offs, 0, H, W,
                           eps, g2 + g_off, g1 + g_off, du_g, dv_g, &du, &dv);
    }
    duv[i] = du;
    duv[n + i] = dv;
  }
}

// --- K3: the tangent's fixed-point unit -------------------------------------

constexpr int kNonFinite = -100000;  // tangent_exponent's mark for a non-finite bound

// Bits of each frame's bound b (see the header): bound[frame].  A NaN or
// inf bound is stored as +inf, the largest non-negative double's bits but
// NaN's.  A warp whose 32 events lie in one frame reduces them with
// shuffles to one atomicMax (one address takes ~N / 32 atomics, not N); a
// warp across a frame boundary adds each lane's own.  Every lane runs the
// same rounds, so the shuffles see the whole warp.
template <typename T>
__global__ void jvp_bound_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                 const T* __restrict__ dtf, const T* __restrict__ wt,
                                 const int* __restrict__ bins, int n_bins, Frames fr, int n,
                                 const T* __restrict__ dflow, Offsets<T> offs, int H, int W,
                                 unsigned long long* __restrict__ bound) {
  const int hw = H * W;
  for (int base = blockIdx.x * blockDim.x; base < n; base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    unsigned long long m = 0;
    int f = -1;
    if (i < n) {
      f = frame_of(fr, i);
      const T w = wt[i];
      const int p = source_pixel(x[i], y[i], H, W);
      if (w != T(0) && p >= 0) {  // else a zero tangent vote
        const T* dfl = dflow + 2 * hw * slab_of(f, bins, n_bins, i);
        const double d = static_cast<double>(dtf[i]);
        double dt_max = 0.0;
        for (int k = 0; k < offs.n; ++k) dt_max = fmax(dt_max, fabs(d - static_cast<double>(offs.v[k])));
        double b = fabs(static_cast<double>(w)) * dt_max *
                   (fabs(static_cast<double>(dfl[p])) + fabs(static_cast<double>(dfl[hw + p])));
        if (!(b <= 1.7976931348623157e308)) b = INFINITY;
        m = static_cast<unsigned long long>(__double_as_longlong(b));
      }
    }
    const int f0 = __shfl_sync(0xffffffffu, f, 0);
    if (__all_sync(0xffffffffu, f == f0)) {
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
        m = other > m ? other : m;
      }
      if ((threadIdx.x & 31) == 0 && m) atomicMax(bound + f0, m);
    } else if (m) {
      atomicMax(bound + f, m);
    }
  }
}

// 61 - ceil(log2 N) for a frame of N events (see the header).
__device__ __forceinline__ int scale_bits_of(int n_events) {
  return 61 - (n_events > 1 ? 32 - __clz(n_events - 1) : 0);
}

// s of the unit 2^-s for the bound's bits and the frame's scale bits.
__device__ __forceinline__ int tangent_exponent(unsigned long long bits, int scale_bits) {
  const double b = __longlong_as_double(static_cast<long long>(bits));
  if (!(b <= 1.7976931348623157e308)) return kNonFinite;
  if (b == 0.0) return 0;  // every tangent vote is 0
  int e;
  frexp(b, &e);  // b < 2^e
  return scale_bits - e;
}

// Frame f's tangent exponent.
__device__ __forceinline__ int frame_exponent(const unsigned long long* bound, Frames fr, int f,
                                              int n) {
  return tangent_exponent(bound[f], scale_bits_of(frame_events(fr, f, n)));
}

template <typename T>
__device__ __forceinline__ void add_scaled(unsigned long long* acc, T value, int ex) {
  const long long q = __double2ll_rn(ldexp(static_cast<double>(value), ex));
  atomicAdd(acc, static_cast<unsigned long long>(q));
}

// Tangent votes of one warped position moving by (dxw, dyw).
template <typename T>
__device__ __forceinline__ void vote_tangent(unsigned long long* img, T xw, T yw, T dxw, T dyw,
                                             T wt, T eps, int H, int W, int ex) {
  int r0, c0;
  T fx, fy;
  if (!corners(xw, yw, eps, H, W, &r0, &c0, &fx, &fy)) return;
  const bool in_r0 = r0 >= 0, in_r1 = r0 + 1 < H;
  const bool in_c0 = c0 >= 0, in_c1 = c0 + 1 < W;
  if (in_r0 && in_c0) add_scaled(img + r0 * W + c0, ((-dxw) * (T(1) - fy) + (T(1) - fx) * (-dyw)) * wt, ex);
  if (in_r1 && in_c0) add_scaled(img + (r0 + 1) * W + c0, (dxw * (T(1) - fy) + fx * (-dyw)) * wt, ex);
  if (in_r0 && in_c1) add_scaled(img + r0 * W + c0 + 1, ((-dxw) * fy + (T(1) - fx) * dyw) * wt, ex);
  if (in_r1 && in_c1) add_scaled(img + (r0 + 1) * W + c0 + 1, (dxw * fy + fx * dyw) * wt, ex);
}

// K3: value votes (K1's code, K1's unit) when emit_value, and tangent votes
// in the frame's unit.
template <typename T>
__global__ void fused_iwe_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     const int* __restrict__ bins, int n_bins, Frames fr,
                                     int n, const T* __restrict__ flow,
                                     const T* __restrict__ dflow, Offsets<T> offs, int H, int W,
                                     T eps, int emit_value,
                                     const unsigned long long* __restrict__ bound,
                                     unsigned long long* __restrict__ acc_val,
                                     unsigned long long* __restrict__ acc_tan) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T w = wt[i];
    if (w == T(0)) continue;
    const int f = frame_of(fr, i);
    const int ex = frame_exponent(bound, fr, f, n);
    const int img = f * offs.n * hw;  // the frame's image block
    const T xi = x[i], yi = y[i];
    const int p = source_pixel(xi, yi, H, W);
    const int off = 2 * hw * slab_of(f, bins, n_bins, i);
    const T u = p >= 0 ? flow[off + p] : T(0);
    const T v = p >= 0 ? flow[off + hw + p] : T(0);
    const T du = p >= 0 ? dflow[off + p] : T(0);
    const T dv = p >= 0 ? dflow[off + hw + p] : T(0);
    const T d = dtf[i];
    for (int k = 0; k < offs.n; ++k) {
      const T dt = d - offs.v[k];
      const T xw = xi - dt * u;
      const T yw = yi - dt * v;
      if (emit_value) vote(acc_val + img + k * hw, xw, yw, w, eps, H, W);
      if (p >= 0 && ex != kNonFinite) {
        vote_tangent(acc_tan + img + k * hw, xw, yw, -(dt * du), -(dt * dv), w, eps, H, W, ex);
      }
    }
  }
}

// The tangent images [B, K, H, W] from their fixed-point sums, each frame
// in its own unit (per_frame = K * H * W elements).
template <typename T>
__global__ void from_scaled_kernel(const long long* __restrict__ acc, int n_out, int per_frame,
                                   const unsigned long long* __restrict__ bound, Frames fr, int n,
                                   T* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out; i += gridDim.x * blockDim.x) {
    const int ex = frame_exponent(bound, fr, i / per_frame, n);
    out[i] = ex == kNonFinite ? static_cast<T>(NAN)
                              : static_cast<T>(ldexp(static_cast<double>(acc[i]), -ex));
  }
}

// Backward, step 2: the first event of each run of consecutive events with
// one (frame, bin, source pixel) key sums the run's du, dv in index order
// and adds the sums to that frame's bin's pixel.
template <typename T>
__global__ void fused_iwe_bwd_sum_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                         const int* __restrict__ bins, int n_bins, Frames fr,
                                         int n, int H, int W, const T* __restrict__ duv,
                                         T* __restrict__ dflow) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int key = run_key(x, y, bins, n_bins, fr, i, H, W);
    if (key < 0) continue;  // the gradient's target pixel is outside the flow
    if (i > 0 && run_key(x, y, bins, n_bins, fr, i - 1, H, W) == key) continue;  // not a run head
    T du = T(0), dv = T(0);
    for (int j = i; j < n && run_key(x, y, bins, n_bins, fr, j, H, W) == key; ++j) {
      du += duv[j];
      dv += duv[n + j];
    }
    T* target = dflow + 2 * hw * (key / hw) + key % hw;
    atomicAdd(target, du);
    atomicAdd(target + hw, dv);
  }
}

template <typename T>
Offsets<T> make_offsets(const double* offsets, int n_off) {
  Offsets<T> o;
  o.n = n_off;
  for (int k = 0; k < kMaxOffsets; ++k) o.v[k] = k < n_off ? static_cast<T>(offsets[k]) : T(0);
  return o;
}

Frames make_frames(const int* frame_ptr, int n_frames) {
  return Frames{frame_ptr, frame_ptr == nullptr ? 1 : n_frames};
}

// Every launcher: bins == nullptr with n_bins == 0 for a dense flow, else
// int32 bins [n] and n_bins slices per frame; frame_ptr == nullptr for one
// frame, else int32 [n_frames + 1] (see the header).  The flow, the tangent
// flow and the backward's output are [(B,) (T,) 2, H, W], the images and
// their cotangents [(B,) K, H, W].
// acc: zeroed int64 scratch of the out's size.
template <typename T>
int launch_fwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const double* offsets,
               int n_off, int include_orig, int H, int W, double eps, long long* acc, T* out,
               void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Frames fr = make_frames(frame_ptr, n_frames);
  if (n > 0) {
    fused_iwe_fwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, bins, n_bins, fr, n, flow, make_offsets<T>(offsets, n_off), include_orig,
        H, W, static_cast<T>(eps), reinterpret_cast<unsigned long long*>(acc));
  }
  const int n_out = fr.n * (n_off + (include_orig ? 1 : 0)) * H * W;
  if (n_out > 0) from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// duv: scratch of 2 * n elements; dflow: zeroed.
template <typename T>
int launch_bwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const double* offsets,
               int n_off, int include_orig, int H, int W, double eps, const T* g, T* duv,
               T* dflow, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Frames fr = make_frames(frame_ptr, n_frames);
  if (n > 0 && n_off > 0) {
    fused_iwe_bwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, bins, n_bins, fr, n, flow, make_offsets<T>(offsets, n_off), include_orig,
        H, W, static_cast<T>(eps), g, duv);
    fused_iwe_bwd_sum_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, y, bins, n_bins, fr, n, H, W,
                                                                 duv, dflow);
  }
  return static_cast<int>(cudaGetLastError());
}

// bound: zeroed scratch of one element per frame; acc_val (emit_value
// only) and acc_tan: zeroed int64 scratch of the outputs' size; out_val
// may be null without emit_value.
template <typename T>
int launch_jvp(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const T* dflow,
               const double* offsets, int n_off, int H, int W, double eps, int emit_value,
               unsigned long long* bound, long long* acc_val, long long* acc_tan, T* out_val,
               T* out_tan, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets<T> offs = make_offsets<T>(offsets, n_off);
  const Frames fr = make_frames(frame_ptr, n_frames);
  if (n > 0) {
    jvp_bound_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, y, dtf, wt, bins, n_bins, fr, n, dflow,
                                                         offs, H, W, bound);
    fused_iwe_jvp_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, bins, n_bins, fr, n, flow, dflow, offs, H, W, static_cast<T>(eps),
        emit_value, bound, reinterpret_cast<unsigned long long*>(acc_val),
        reinterpret_cast<unsigned long long*>(acc_tan));
  }
  const int per_frame = n_off * H * W;
  const int n_out = fr.n * per_frame;
  if (emit_value) from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc_val, n_out, out_val);
  from_scaled_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc_tan, n_out, per_frame, bound, fr,
                                                             n, out_tan);
  return static_cast<int>(cudaGetLastError());
}

// duv: scratch of 2 * n elements; dflow_out: zeroed.
template <typename T>
int launch_hvp_bwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
                   const int* frame_ptr, int n_frames, int n, const T* flow, const T* dflow,
                   const double* offsets, int n_off, int H, int W, double eps, int term_a,
                   const T* g1, const T* g2, T* duv, T* dflow_out, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets<T> offs = make_offsets<T>(offsets, n_off);
  const Frames fr = make_frames(frame_ptr, n_frames);
  if (n > 0) {
    if (term_a) {
      fused_iwe_hvp_bwd_kernel<T, true><<<grid_for(n), kThreads, 0, s>>>(
          x, y, dtf, wt, bins, n_bins, fr, n, flow, dflow, offs, H, W, static_cast<T>(eps), g1, g2,
          duv);
    } else {
      fused_iwe_hvp_bwd_kernel<T, false><<<grid_for(n), kThreads, 0, s>>>(
          x, y, dtf, wt, bins, n_bins, fr, n, flow, dflow, offs, H, W, static_cast<T>(eps), g1, g2,
          duv);
    }
    fused_iwe_bwd_sum_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, y, bins, n_bins, fr, n, H, W,
                                                                 duv, dflow_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: one entry point per kernel and type, each the launcher
// above with T = float (f32) or double (f64).
#define EVFLOW_EVENTS(T)                                                                            \
  const T *x, const T *y, const T *dtf, const T *wt, const int *bins, int n_bins,                  \
      const int *frame_ptr, int n_frames, int n
#define EVFLOW_EVENT_ARGS x, y, dtf, wt, bins, n_bins, frame_ptr, n_frames, n
#define EVFLOW_ENTRY_POINTS(T, SUFFIX)                                                             \
  int evflow_fused_iwe_fwd_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const double* offsets,        \
                                    int n_off, int include_orig, int H, int W, double eps,         \
                                    long long* acc, T* out, void* stream) {                        \
    return launch_fwd<T>(EVFLOW_EVENT_ARGS, flow, offsets, n_off, include_orig, H, W, eps, acc,    \
                         out, stream);                                                             \
  }                                                                                                \
  int evflow_fused_iwe_bwd_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const double* offsets,        \
                                    int n_off, int include_orig, int H, int W, double eps,         \
                                    const T* g, T* duv, T* dflow, void* stream) {                  \
    return launch_bwd<T>(EVFLOW_EVENT_ARGS, flow, offsets, n_off, include_orig, H, W, eps, g, duv, \
                         dflow, stream);                                                           \
  }                                                                                                \
  int evflow_fused_iwe_jvp_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const T* dflow,               \
                                    const double* offsets, int n_off, int H, int W, double eps,    \
                                    int emit_value, unsigned long long* bound, long long* acc_val, \
                                    long long* acc_tan, T* out_val, T* out_tan, void* stream) {    \
    return launch_jvp<T>(EVFLOW_EVENT_ARGS, flow, dflow, offsets, n_off, H, W, eps, emit_value,    \
                         bound, acc_val, acc_tan, out_val, out_tan, stream);                       \
  }                                                                                                \
  int evflow_fused_iwe_hvp_bwd_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const T* dflow,           \
                                        const double* offsets, int n_off, int H, int W,            \
                                        double eps, int term_a, const T* g1, const T* g2, T* duv,  \
                                        T* dflow_out, void* stream) {                              \
    return launch_hvp_bwd<T>(EVFLOW_EVENT_ARGS, flow, dflow, offsets, n_off, H, W, eps, term_a,    \
                             g1, g2, duv, dflow_out, stream);                                      \
  }

extern "C" {

int evflow_max_offsets() { return kMaxOffsets; }

EVFLOW_ENTRY_POINTS(float, f32)
EVFLOW_ENTRY_POINTS(double, f64)

}  // extern "C"
