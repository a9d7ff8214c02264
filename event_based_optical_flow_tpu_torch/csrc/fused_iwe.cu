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
// second kernel (the helpers in fixed_point.cuh, shared with vote.cu, K8).
// Integer addition is associative, so the images are the same bits
// whatever order the atomics land in: the forward is reproducible from run
// to run.  A float32 vote of magnitude >= 2^-13 is converted exactly; the
// sum overflows only past 2^(63-kFixBits) weight units in one pixel (the
// wrapper bounds the event count).  One thread per event in grid-stride
// loops; nothing is staged in shared memory.  Designs that sum the votes in
// shared memory (tiles of output rows fed by a binning pass, a cluster's
// distributed shared memory) gave the same bits but ran slower on an H100
// (PERF.md), so the global atomics stay.
//
// Backward, given the image cotangent g [K, H, W]:
//   d/dxw = wt * sum over the 4 corners of g * (one-sided corner
//   derivative: -1 at fl, +1 at fl+1) * (the other axis' corner weight),
//   likewise d/dyw; du += -(dtf-o) d/dxw, dv += -(dtf-o) d/dyw over the
//   offsets (the orig image has no flow dependence); du, dv go to
//   dflow[:, (int)x, (int)y].  x, y, dtf and wt get no gradient.
// One kernel (fused_iwe_grad_kernel) after a memset of dflow: each block
// computes the du, dv of a chunk of events (and a few past it) into shared
// memory, and the first event of each run of consecutive events with one
// source pixel sums the run in index order from 0 and adds it to that
// pixel with one atomicAdd.  With the events sorted by source pixel
// (FrameEvents sorts them) every pixel gets exactly one add, onto zero, so
// dflow is reproducible from run to run too; unsorted events give the same
// sum up to the order of a few adds.  No per-event term goes to device
// memory.
//
// Outer padding and the count vote (solver.outer_padding, iwe.method:
// count; the JAX package's unfused objective, objective.py:192-322, which
// warps with multi_direction_dense_warp and then votes with
// EventImageConverter): every kernel takes pad >= 0, and the images, their
// cotangents and tangents are then (H + 2 pad) x (W + 2 pad); each warped
// coordinate votes at c + pad (fixed_point.cuh's padded(), c itself for pad
// 0: an unpadded launch keeps its bits), while the flow is still gathered
// at the unpadded, truncated source pixel.  The corner derivatives are those
// of c, so the backward, the tangent and K4 read the padded cotangents at
// the padded corners with the same expressions.  The forward's count flag
// votes w at each in-image corner (the JAX package's count_vote); a count
// image has no flow derivative, so the wrappers launch no backward, tangent
// or HVP kernel for it (their results are zeros).
//
// What bounds them on the H100: the forward's scattered 8-byte integer
// atomic adds (4 per event per offset) and the backward's gathers of g (4
// per event per offset) — not FLOPs (a few dozen per event).

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
// the same bits on every run.  Four device operations a call: one memset of
// one scratch (the sums and the per-frame bounds); the bound pass; the
// vote, which takes the frame's exponent once per event from the bound's
// bits by integer operations, scales each vote by one multiply with 2^s
// (ldexp only where 2^s is no normal double: a tiny b) and, in a large
// launch where sorted events land close together, sums a warp's votes to
// one pixel in registers before one RED; the conversion, two outputs a
// thread with 16-byte loads.  The vote is bound by its scattered 8-byte RED
// atomics, as K1 is.
// HVP backward (K4), given the cost cotangent g1 and its directional
// derivative g2 [K, H, W]: per event
//   term B   K2's du, dv against g2 (the same code: with term A off this is
//            fused_iwe_bwd(g2) bit for bit);
//   term A   s = wt (g1[fl,cl] - g1[fl,cl+1] - g1[fl+1,cl] + g1[fl+1,cl+1])
//            (the vote's mixed second derivative against g1),
//            du += dt^2 s dv_g,  dv += dt^2 s du_g,
// per offset, in K2's one-pass kernel (a template over term A) with its
// ordered run sums onto the source pixel.  K3 keeps global int64 atomics
// for its votes (bound by them and its gathers: a frame's tangent images
// do not fit a block's shared memory, as K1's do not); K4 is bound like K2,
// reading g1 only with term A.
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
//
// An event-sharded frame (the parallel: mesh; ops/fused_iwe.py's
// sharded entry points, solver/objective.py's sharded objective) runs the
// same kernels in another order.  The forward splits into its vote into
// the caller's zeroed int64 sums (fused_iwe_fwd_acc: one per shard) and
// the conversion (fused_iwe_from_fixed: once, on the integer sum of the
// shards' sums), so the images are the unsharded call's bits.  The tangent
// splits into its bound pass (fused_iwe_jvp_bound: per shard, reduced by a
// max), its vote in the unit of the reduced bound and of the whole frame's
// event count (fused_iwe_jvp_acc, unit_events) and its conversion
// (fused_iwe_from_scaled): every tangent vote is then rounded to the
// unsharded call's unit, and the integer sums add up to its sums.  The
// backward and K4 need no split: cut at run boundaries of the sort key,
// each (bin,) pixel's run lies in one shard, whose one-pass kernel sums it
// from the run's head as the unsharded kernel does; the other shards add
// exact zeros there.  The split entry points take one frame (no frame
// table).

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

// --- K1 (K5, K7, K9): the forward ------------------------------------------

template <typename T>
__global__ void fused_iwe_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     const int* __restrict__ bins, int n_bins, Frames fr,
                                     int n, const T* __restrict__ flow, Offsets<T> offs,
                                     int include_orig, int H, int W, int pad, int count, T eps,
                                     unsigned long long* __restrict__ acc) {
  const int hw = H * W;
  const int Hi = H + 2 * pad, Wi = W + 2 * pad;  // the images' size
  const int hwi = Hi * Wi;
  const int k0 = include_orig ? 1 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T w = wt[i];
    if (w == T(0)) continue;
    const int f = frame_of(fr, i);
    unsigned long long* img = acc + f * (k0 + offs.n) * hwi;  // the frame's image block
    const T xi = x[i], yi = y[i];
    if (include_orig) vote(img, padded(xi, pad), padded(yi, pad), w, eps, Hi, Wi, count);
    if (offs.n == 0) continue;
    const int p = source_pixel(xi, yi, H, W);
    const T* fl = flow + 2 * hw * slab_of(f, bins, n_bins, i);
    const T u = p >= 0 ? fl[p] : T(0);
    const T v = p >= 0 ? fl[hw + p] : T(0);
    const T d = dtf[i];
    for (int k = 0; k < offs.n; ++k) {
      const T dt = d - offs.v[k];
      const T xw = padded(xi - dt * u, pad);
      const T yw = padded(yi - dt * v, pad);
      vote(img + (k0 + k) * hwi, xw, yw, w, eps, Hi, Wi, count);
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
// H, W: the images' size (padded by pad).
template <typename T, bool TermA>
__device__ __forceinline__ void event_grad(T xi, T yi, T d, T w, T u, T v, const Offsets<T>& offs,
                                           int k0, int H, int W, int pad, T eps, const T* g, const T* g1,
                                           T du_g, T dv_g, T* du, T* dv) {
  const int hw = H * W;
  for (int k = 0; k < offs.n; ++k) {
    const T dt = d - offs.v[k];
    const T xw = padded(xi - dt * u, pad);
    const T yw = padded(yi - dt * v, pad);
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

// --- K2 (K4, K5, K7, K9): the backward in one pass -------------------------

constexpr int kGradChunk = 128;    // the events whose runs a block sums
constexpr int kGradOverlap = 32;   // events past its chunk a block computes with it
constexpr int kGradThreads = kGradChunk + kGradOverlap;

template <typename T>
struct GradArgs {
  const T *x, *y, *dtf, *wt;
  const int* bins;
  int n_bins;
  Frames fr;
  int n;
  const T* flow;
  const T* dflow;  // the tangent flow, read with TermA only
  Offsets<T> offs;
  int k0, H, W;  // k0: 1 when the cotangent's image 0 is the orig image
  int pad;       // the images' outer padding: they are (H + 2 pad) x (W + 2 pad)
  T eps;
  const T* g;   // the cotangent [(B,) k0 + K, H + 2 pad, W + 2 pad]
  const T* g1;  // K4's first cotangent [(B,) K, H + 2 pad, W + 2 pad], read with TermA only
};

// Event i's run key ((frame * T + bin) * H * W + source pixel, or -1
// outside the flow) and its du, dv (0 for a padded event).
template <typename T, bool TermA>
__device__ __forceinline__ int event_terms(const GradArgs<T>& a, int i, T* du, T* dv) {
  const int hw = a.H * a.W;
  const T xi = a.x[i], yi = a.y[i], w = a.wt[i];
  const int p = source_pixel(xi, yi, a.H, a.W);
  *du = T(0);
  *dv = T(0);
  if (p < 0) return -1;
  const int f = frame_of(a.fr, i);
  const int slab = slab_of(f, a.bins, a.n_bins, i);
  if (w != T(0)) {
    const int off = 2 * hw * slab;
    const int Hi = a.H + 2 * a.pad, Wi = a.W + 2 * a.pad;
    const int g_off = f * (a.k0 + a.offs.n) * Hi * Wi;  // the frame's cotangent block
    const T du_g = TermA ? a.dflow[off + p] : T(0);
    const T dv_g = TermA ? a.dflow[off + hw + p] : T(0);
    event_grad<T, TermA>(xi, yi, a.dtf[i], w, a.flow[off + p], a.flow[off + hw + p], a.offs, a.k0, Hi,
                         Wi, a.pad, a.eps, a.g + g_off, TermA ? a.g1 + g_off : nullptr, du_g, dv_g, du, dv);
  }
  return slab * hw + p;
}

// One block per chunk of kGradChunk consecutive events.  Each thread
// computes one event's key and du, dv once, into shared memory: the chunk's
// and the next kGradOverlap events' (a window).  The first event of each
// run of one key in the chunk (a run that began in the previous chunk
// belongs to that chunk's block) sums the run's terms in index order from
// 0, and adds the sums to its pixel of the zeroed dflow.  A run longer than
// the window goes on through further windows, each computed by the whole
// block.  With the events sorted by key every pixel gets one add, onto
// zero: dflow is the same bits on every run, and no per-event term goes to
// device memory.
template <typename T, bool TermA>
__global__ void __launch_bounds__(kGradThreads)
    fused_iwe_grad_kernel(GradArgs<T> a, T* __restrict__ dflow) {
  __shared__ int keys[kGradThreads];
  __shared__ T dus[kGradThreads], dvs[kGradThreads];
  __shared__ int more;
  const int t = threadIdx.x;
  const int first = blockIdx.x * kGradChunk;
  int base = first;  // the window's first event
  auto load_window = [&] {
    const int i = base + t;
    T du = T(0), dv = T(0);
    keys[t] = i < a.n ? event_terms<T, TermA>(a, i, &du, &dv) : -1;
    dus[t] = du;
    dvs[t] = dv;
  };
  load_window();
  __syncthreads();
  int end = min(a.n, base + kGradThreads);  // the window's end
  const int hw = a.H * a.W;
  T su = T(0), sv = T(0);
  const int key = keys[t];
  bool open = false;  // this thread's run goes on past the window
  auto add = [&] {
    T* target = dflow + 2 * hw * (key / hw) + key % hw;
    atomicAdd(target, su);
    atomicAdd(target + hw, sv);
  };
  auto sum_from = [&](int j) {  // sums the run from window slot j; true if it reaches the window's end
    for (; base + j < end && keys[j] == key; ++j) {
      su += dus[j];
      sv += dvs[j];
    }
    return base + j == end && end < a.n;
  };
  if (t < kGradChunk && key >= 0) {
    const int i = first + t;
    const int prev = t > 0 ? keys[t - 1] : (i > 0 ? run_key(a.x, a.y, a.bins, a.n_bins, a.fr, i - 1, a.H, a.W) : -1);
    if (prev != key) {  // a run head
      open = sum_from(t);
      if (!open) add();
    }
  }
  for (;;) {  // at most one run, the one holding the window's last event, goes on
    if (t == 0) more = 0;
    __syncthreads();
    if (open) more = 1;
    __syncthreads();
    if (!more) break;
    base = end;
    load_window();
    __syncthreads();
    end = min(a.n, base + kGradThreads);
    if (open) {
      open = sum_from(0);
      if (!open) add();
    }
  }
}

// --- K3: the tangent's fixed-point unit -------------------------------------

constexpr int kNonFinite = -100000;  // tangent_exponent's mark for a non-finite bound

// Bits of each frame's bound b (see the header): bound[frame], zeroed
// before.  A NaN or inf bound is stored as +inf, the largest non-negative
// double's bits but NaN's.  A warp whose 32 events lie in one frame reduces
// them with shuffles, and the block's warps of one frame combine theirs in
// shared memory, to one atomicMax per block and frame (one address takes
// ~N / 256 atomics, not N); a warp across a frame boundary adds each lane's
// own.  Every lane runs the same rounds, so the shuffles see the whole warp
// and every thread reaches the block's barriers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    jvp_bound_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dtf,
                     const T* __restrict__ wt, const int* __restrict__ bins, int n_bins, Frames fr, int n,
                     const T* __restrict__ dflow, Offsets<T> offs, int H, int W,
                     unsigned long long* __restrict__ bound) {
  __shared__ unsigned long long warp_max[kThreads / 32];
  __shared__ int warp_frame[kThreads / 32];  // -1: nothing left to add
  const int hw = H * W;
  const int warp = threadIdx.x / 32;
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
    const bool one_frame = __all_sync(0xffffffffu, f == f0);
    if (one_frame) {
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
        m = other > m ? other : m;
      }
    } else if (m) {
      atomicMax(bound + f, m);
    }
    if ((threadIdx.x & 31) == 0) {
      warp_max[warp] = m;
      warp_frame[warp] = one_frame && m ? f0 : -1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // the block's warps in order: one atomicMax per run of one frame
      int run_f = -1;
      unsigned long long run_m = 0;
      for (int k = 0; k < kThreads / 32; ++k) {
        if (warp_frame[k] < 0) continue;
        if (warp_frame[k] != run_f) {
          if (run_m) atomicMax(bound + run_f, run_m);
          run_f = warp_frame[k];
          run_m = 0;
        }
        run_m = warp_max[k] > run_m ? warp_max[k] : run_m;
      }
      if (run_m) atomicMax(bound + run_f, run_m);
    }
    __syncthreads();
  }
}

// 61 - ceil(log2 N) for a frame of N events (see the header).
__device__ __forceinline__ int scale_bits_of(int n_events) {
  return 61 - (n_events > 1 ? 32 - __clz(n_events - 1) : 0);
}

// frexp's exponent e of a positive finite double from its bits (2^(e-1) <=
// b < 2^e), by integer operations: the biased exponent of a normal b, the
// mantissa's length of a subnormal one.
__device__ __forceinline__ int exponent_of(unsigned long long bits) {
  const int biased = static_cast<int>(bits >> 52);
  return biased != 0 ? biased - 1022 : (64 - __clzll(static_cast<long long>(bits))) - 1074;
}

// s of the unit 2^-s for the bound's bits and the frame's scale bits:
// s = scale_bits - e with frexp's e of b, 0 for b == 0, kNonFinite for a
// non-finite b.  The bound's N < 2^30 events keep s >= 61 - 30 - 1024, so
// 2^s and 2^-s overflow only upward (a tiny b): s > 1023.
__device__ __forceinline__ int tangent_exponent(unsigned long long bits, int scale_bits) {
  if (bits > 0x7fefffffffffffffull) return kNonFinite;  // +inf: a NaN or inf bound
  if (bits == 0) return 0;                              // every tangent vote is 0
  return scale_bits - exponent_of(bits);
}

// Frame f's tangent exponent.
__device__ __forceinline__ int frame_exponent(const unsigned long long* bound, Frames fr, int f,
                                              int n) {
  return tangent_exponent(bound[f], scale_bits_of(frame_events(fr, f, n)));
}

// 2^e as a double, for e in [-1022, 1023] (a normal double).
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
}

// A frame's unit: the exponent s and, where 2^s is a normal double, 2^s.
struct TangentUnit {
  int ex;
  double scale;
  __device__ __forceinline__ explicit TangentUnit(int e)
      : ex(e), scale(e >= -1022 && e <= 1023 ? pow2(e) : 0.0) {}
  // v 2^ex rounded half to even to an int64: one multiply by 2^ex where that
  // is a normal double (the product is the exact v 2^ex rounded once, as
  // ldexp rounds it), ldexp beyond it (a tiny bound).
  __device__ __forceinline__ long long units(double v) const {
    return __double2ll_rn(scale != 0.0 ? v * scale : ldexp(v, ex));
  }
};

// A launch of at least kAggregateEvents events aggregates each warp's
// tangent votes (enough blocks that the REDs' throughput, not their latency,
// bounds the vote: measured on an H100, 60 000 events gain, 30 000 lose);
// a smaller one adds each lane's votes on its own.
constexpr int kAggregateEvents = 48 * 1024;

// The lanes of a warp whose votes go to one sum (key) add them up
// (integers: any order gives the same sum) and the lowest of them adds the
// total with one RED.  Every lane of the warp calls it; a lane with nothing
// to add passes add = false and a key of its own.
__device__ __forceinline__ void red_aggregated(unsigned long long* acc, unsigned key, long long q, bool add) {
  const int lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1u));  // this lane's rank among its peers
  peers &= 0xfffffffeu << lane;                   // the peers above it
  while (__any_sync(0xffffffffu, peers)) {        // a tree sum over each set of peers
    const int next = __ffs(peers);
    const long long t = __shfl_sync(0xffffffffu, q, next - 1);
    if (next) q += t;
    peers &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
  if (add && lane == first) atomicAdd(acc + key, static_cast<unsigned long long>(q));
}

// K3: tangent votes in the frame's unit, taken once per event, and with
// emit_value the value votes (K1's code, K1's unit).  unit_n: the event
// count of a single frame's unit (n, or the whole frame's for a shard of
// it); a frame table's frames take their own counts.  With Aggregate every
// lane of a warp runs the same rounds (one event each) and each set of equal
// destinations is summed in registers first: one RED per distinct pixel
// instead of one per vote.
template <typename T, bool Aggregate>
__global__ void fused_iwe_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dtf, const T* __restrict__ wt,
                                     const int* __restrict__ bins, int n_bins, Frames fr,
                                     int n, const T* __restrict__ flow,
                                     const T* __restrict__ dflow, Offsets<T> offs, int H, int W,
                                     int pad, T eps, int emit_value, int unit_n,
                                     const unsigned long long* __restrict__ bound,
                                     unsigned long long* __restrict__ acc_val,
                                     unsigned long long* __restrict__ acc_tan) {
  const int hw = H * W;
  const int Hi = H + 2 * pad, Wi = W + 2 * pad;  // the images' size
  const int hwi = Hi * Wi;
  const unsigned own_key = 0xffffffe0u + (threadIdx.x & 31);  // no output's index (n_out < 2^31)
  for (int base = blockIdx.x * blockDim.x; base < n; base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    T w = T(0), xi = T(0), yi = T(0), u = T(0), v = T(0), du = T(0), dv = T(0), d = T(0);
    int p = -1, f = 0;
    if (i < n) {
      w = wt[i];
      if (w != T(0)) {
        f = frame_of(fr, i);
        xi = x[i];
        yi = y[i];
        p = source_pixel(xi, yi, H, W);
        d = dtf[i];
        if (p >= 0) {
          const int off = 2 * hw * slab_of(f, bins, n_bins, i);
          u = flow[off + p];
          v = flow[off + hw + p];
          du = dflow[off + p];
          dv = dflow[off + hw + p];
        }
      }
    }
    const TangentUnit unit(p >= 0 ? frame_exponent(bound, fr, f, unit_n) : kNonFinite);
    const bool tangent = unit.ex != kNonFinite;  // a voting event with a finite bound
    const int img = f * offs.n * hwi;            // the frame's image block
    for (int k = 0; k < offs.n; ++k) {
      const T dt = d - offs.v[k];
      const T xw = padded(xi - dt * u, pad);
      const T yw = padded(yi - dt * v, pad);
      if (emit_value && w != T(0)) vote(acc_val + img + k * hwi, xw, yw, w, eps, Hi, Wi);
      int r0 = 0, c0 = 0;
      T fx = T(0), fy = T(0);
      const bool any = tangent && corners(xw, yw, eps, Hi, Wi, &r0, &c0, &fx, &fy);
      const T dxw = -(dt * du), dyw = -(dt * dv);
      const int cell = img + k * hwi + r0 * Wi + c0;
      const bool in_r0 = r0 >= 0, in_r1 = r0 + 1 < Hi, in_c0 = c0 >= 0, in_c1 = c0 + 1 < Wi;
      const bool ok[4] = {any && in_r0 && in_c0, any && in_r1 && in_c0, any && in_r0 && in_c1,
                          any && in_r1 && in_c1};
      const int at[4] = {0, Wi, 1, Wi + 1};  // the corners' offsets from the cell
      const T val[4] = {((-dxw) * (T(1) - fy) + (T(1) - fx) * (-dyw)) * w,
                        (dxw * (T(1) - fy) + fx * (-dyw)) * w, ((-dxw) * fy + (T(1) - fx) * dyw) * w,
                        (dxw * fy + fx * dyw) * w};
      for (int c = 0; c < 4; ++c) {
        const long long q = ok[c] ? unit.units(static_cast<double>(val[c])) : 0;
        if (Aggregate) {
          red_aggregated(acc_tan, ok[c] ? static_cast<unsigned>(cell + at[c]) : own_key, q, ok[c]);
        } else if (ok[c]) {
          atomicAdd(acc_tan + cell + at[c], static_cast<unsigned long long>(q));
        }
      }
    }
  }
}

template <typename T>
struct Pair;  // two outputs, one store
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// One tangent output from its sum: sum 2^-ex in T, NaN for a non-finite
// bound (one multiply where 2^-ex is a normal double, ldexp beyond).
template <typename T>
__device__ __forceinline__ T from_units(long long sum, int ex) {
  if (ex == kNonFinite) return static_cast<T>(NAN);
  const double v = static_cast<double>(sum);
  return static_cast<T>(ex <= 1022 ? v * pow2(-ex) : ldexp(v, -ex));
}

// The tangent images [B, K, H, W] from their fixed-point sums, each frame
// in its own unit (per_frame = K * H * W elements), two elements a thread
// with 16-byte loads; with acc_val the value images too, K1's conversion.
template <typename T>
__global__ void from_scaled_kernel(const long long* __restrict__ acc_tan,
                                   const long long* __restrict__ acc_val, int n_out, int per_frame,
                                   const unsigned long long* __restrict__ bound, Frames fr, int n,
                                   T* __restrict__ out_tan, T* __restrict__ out_val) {
  using P = typename Pair<T>::type;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; 2 * j < n_out; j += gridDim.x * blockDim.x) {
    const int i = 2 * j;
    const int f = i / per_frame;
    const int ex = frame_exponent(bound, fr, f, n);
    if (i + 1 < n_out) {
      const int ex1 = i + 1 < (f + 1) * per_frame ? ex : frame_exponent(bound, fr, f + 1, n);
      const longlong2 a = reinterpret_cast<const longlong2*>(acc_tan)[j];
      P o;
      o.x = from_units<T>(a.x, ex);
      o.y = from_units<T>(a.y, ex1);
      reinterpret_cast<P*>(out_tan)[j] = o;
      if (acc_val != nullptr) {
        const longlong2 b = reinterpret_cast<const longlong2*>(acc_val)[j];
        o.x = static_cast<T>(static_cast<double>(b.x) * kFixUnit);
        o.y = static_cast<T>(static_cast<double>(b.y) * kFixUnit);
        reinterpret_cast<P*>(out_val)[j] = o;
      }
    } else {
      out_tan[i] = from_units<T>(acc_tan[i], ex);
      if (acc_val != nullptr) out_val[i] = static_cast<T>(static_cast<double>(acc_val[i]) * kFixUnit);
    }
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
// their cotangents [(B,) K, H + 2 pad, W + 2 pad].
// acc: zeroed int64 scratch of the out's size.
template <typename T>
int launch_fwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const double* offsets,
               int n_off, int include_orig, int H, int W, int pad, int count, double eps, long long* acc,
               T* out, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Frames fr = make_frames(frame_ptr, n_frames);
  if (n > 0) {
    fused_iwe_fwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, bins, n_bins, fr, n, flow, make_offsets<T>(offsets, n_off), include_orig,
        H, W, pad, count, static_cast<T>(eps), reinterpret_cast<unsigned long long*>(acc));
  }
  const int n_out = fr.n * (n_off + (include_orig ? 1 : 0)) * (H + 2 * pad) * (W + 2 * pad);
  if (n_out > 0) from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// dflow: the gradient's n_out elements, zeroed here, then the one pass.
template <typename T, bool TermA>
int launch_grad(const GradArgs<T>& a, long long n_out, T* dflow, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(dflow, 0, static_cast<size_t>(n_out) * sizeof(T), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.n > 0 && a.offs.n > 0) {
    fused_iwe_grad_kernel<T, TermA><<<(a.n + kGradChunk - 1) / kGradChunk, kGradThreads, 0, s>>>(a, dflow);
  }
  return static_cast<int>(cudaGetLastError());
}

// The flow's (and its gradient's) element count.
long long flow_elements(const Frames& fr, int n_bins, int H, int W) {
  return static_cast<long long>(fr.n) * (n_bins > 0 ? n_bins : 1) * 2 * H * W;
}

template <typename T>
int launch_bwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const double* offsets,
               int n_off, int include_orig, int H, int W, int pad, double eps, const T* g, T* dflow,
               void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Frames fr = make_frames(frame_ptr, n_frames);
  const GradArgs<T> a{x, y, dtf, wt, bins, n_bins, fr, n, flow, nullptr, make_offsets<T>(offsets, n_off),
                      include_orig ? 1 : 0, H, W, pad, static_cast<T>(eps), g, nullptr};
  return launch_grad<T, false>(a, flow_elements(fr, n_bins, H, W), dflow, stream);
}

// scratch: int64, not zeroed, laid out as the tangent's fixed-point sums
// [n_acc], with emit_value the value's [n_acc], then the bits of each
// frame's bound [n_frames], n_acc the outputs' size rounded up to even;
// zeroed here by one memset.  out_val may be null without emit_value.  The
// scratch and the outputs 16-byte aligned.  Four device operations: the
// memset, the bound pass, the vote and the conversion.
template <typename T>
int launch_jvp(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
               const int* frame_ptr, int n_frames, int n, const T* flow, const T* dflow,
               const double* offsets, int n_off, int H, int W, int pad, double eps, int emit_value,
               long long* scratch, T* out_val, T* out_tan, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {static_cast<const void*>(scratch), static_cast<const void*>(out_tan),
                        static_cast<const void*>(emit_value ? out_val : nullptr)}) {
    if (reinterpret_cast<unsigned long long>(p) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets<T> offs = make_offsets<T>(offsets, n_off);
  const Frames fr = make_frames(frame_ptr, n_frames);
  const int per_frame = n_off * (H + 2 * pad) * (W + 2 * pad);
  const int n_out = fr.n * per_frame;
  const long long n_acc = n_out + (n_out & 1);
  long long* acc_tan = scratch;
  long long* acc_val = emit_value ? scratch + n_acc : nullptr;
  unsigned long long* bound = reinterpret_cast<unsigned long long*>(scratch + (emit_value ? 2 : 1) * n_acc);
  const size_t bytes = static_cast<size_t>((emit_value ? 2 : 1) * n_acc + fr.n) * sizeof(*scratch);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    jvp_bound_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, y, dtf, wt, bins, n_bins, fr, n, dflow, offs, H, W,
                                                         bound);
    auto* jvp = n >= kAggregateEvents ? fused_iwe_jvp_kernel<T, true> : fused_iwe_jvp_kernel<T, false>;
    jvp<<<grid_for(n), kThreads, 0, s>>>(x, y, dtf, wt, bins, n_bins, fr, n, flow, dflow, offs, H, W, pad,
                                         static_cast<T>(eps), emit_value, n, bound,
                                         reinterpret_cast<unsigned long long*>(acc_val),
                                         reinterpret_cast<unsigned long long*>(acc_tan));
  }
  from_scaled_kernel<T><<<grid_for((n_out + 1) / 2), kThreads, 0, s>>>(
      acc_tan, acc_val, n_out, per_frame, bound, fr, n, out_tan, emit_value ? out_val : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// dflow_out: the HVP term's elements, zeroed here.
template <typename T>
int launch_hvp_bwd(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
                   const int* frame_ptr, int n_frames, int n, const T* flow, const T* dflow,
                   const double* offsets, int n_off, int H, int W, int pad, double eps, int term_a,
                   const T* g1, const T* g2, T* dflow_out, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Frames fr = make_frames(frame_ptr, n_frames);
  const GradArgs<T> a{x, y, dtf, wt, bins, n_bins, fr, n, flow, dflow, make_offsets<T>(offsets, n_off),
                      0, H, W, pad, static_cast<T>(eps), g2, g1};
  const long long n_out = flow_elements(fr, n_bins, H, W);
  return term_a ? launch_grad<T, true>(a, n_out, dflow_out, stream)
                : launch_grad<T, false>(a, n_out, dflow_out, stream);
}

// --- the event mesh's split entry points (see the header) ------------------

// K1 (K5): the vote alone, into the caller's zeroed int64 sums acc [(orig)
// + K, H + 2 pad, W + 2 pad]; no conversion.
template <typename T>
int launch_fwd_acc(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
                   const int* frame_ptr, int n_frames, int n, const T* flow, const double* offsets,
                   int n_off, int include_orig, int H, int W, int pad, int count, double eps, long long* acc,
                   void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets || pad < 0 || frame_ptr != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_iwe_fwd_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
        x, y, dtf, wt, bins, n_bins, make_frames(nullptr, 1), n, flow, make_offsets<T>(offsets, n_off),
        include_orig, H, W, pad, count, static_cast<T>(eps), reinterpret_cast<unsigned long long*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's conversion of n_out fixed-point sums.
template <typename T>
int launch_from_fixed(const long long* acc, int n_out, T* out, void* stream) {
  if (n_out > 0) {
    from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(acc, n_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 (K6): the bound pass alone, into the caller's zeroed bound[1] (the
// bits of the shard's bound b).
template <typename T>
int launch_jvp_bound(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
                     const int* frame_ptr, int n_frames, int n, const T* dflow, const double* offsets, int n_off,
                     int H, int W, long long* bound, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || frame_ptr != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    jvp_bound_kernel<T><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, dtf, wt, bins, n_bins, make_frames(nullptr, 1), n, dflow, make_offsets<T>(offsets, n_off), H, W,
        reinterpret_cast<unsigned long long*>(bound));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 (K6): the vote alone in the unit of bound[1] (the frame's, reduced
// over its shards) and of unit_events (the frame's event count), into the
// caller's zeroed int64 sums acc_tan and, with emit_value, acc_val.
template <typename T>
int launch_jvp_acc(const T* x, const T* y, const T* dtf, const T* wt, const int* bins, int n_bins,
                   const int* frame_ptr, int n_frames, int n, const T* flow, const T* dflow,
                   const double* offsets, int n_off, int H, int W, int pad, double eps, int emit_value,
                   int unit_events, const long long* bound, long long* acc_val, long long* acc_tan,
                   void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || pad < 0 || frame_ptr != nullptr || unit_events < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    auto* jvp = n >= kAggregateEvents ? fused_iwe_jvp_kernel<T, true> : fused_iwe_jvp_kernel<T, false>;
    jvp<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, dtf, wt, bins, n_bins, make_frames(nullptr, 1), n, flow, dflow, make_offsets<T>(offsets, n_off), H,
        W, pad, static_cast<T>(eps), emit_value, unit_events, reinterpret_cast<const unsigned long long*>(bound),
        reinterpret_cast<unsigned long long*>(acc_val), reinterpret_cast<unsigned long long*>(acc_tan));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's conversion of one frame's n_out sums in the unit of bound[1] and
// unit_events (acc_val may be null); the sums and outputs 16-byte aligned.
template <typename T>
int launch_from_scaled(const long long* acc_tan, const long long* acc_val, int n_out, const long long* bound,
                       int unit_events, T* out_tan, T* out_val, void* stream) {
  for (const void* p : {static_cast<const void*>(acc_tan), static_cast<const void*>(acc_val),
                        static_cast<const void*>(out_tan), static_cast<const void*>(out_val)}) {
    if (reinterpret_cast<unsigned long long>(p) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_out > 0) {
    from_scaled_kernel<T><<<grid_for((n_out + 1) / 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        acc_tan, acc_val, n_out, n_out, reinterpret_cast<const unsigned long long*>(bound), make_frames(nullptr, 1),
        unit_events, out_tan, out_val);
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
                                    int n_off, int include_orig, int H, int W, int pad, int count, \
                                    double eps, long long* acc, T* out, void* stream) {            \
    return launch_fwd<T>(EVFLOW_EVENT_ARGS, flow, offsets, n_off, include_orig, H, W, pad, count,  \
                         eps, acc, out, stream);                                                   \
  }                                                                                                \
  int evflow_fused_iwe_bwd_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const double* offsets,        \
                                    int n_off, int include_orig, int H, int W, int pad,            \
                                    double eps, const T* g, T* dflow, void* stream) {              \
    return launch_bwd<T>(EVFLOW_EVENT_ARGS, flow, offsets, n_off, include_orig, H, W, pad, eps, g, \
                         dflow, stream);                                                           \
  }                                                                                                \
  int evflow_fused_iwe_jvp_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const T* dflow,               \
                                    const double* offsets, int n_off, int H, int W, int pad,       \
                                    double eps, int emit_value, long long* scratch, T* out_val,    \
                                    T* out_tan, void* stream) {                                    \
    return launch_jvp<T>(EVFLOW_EVENT_ARGS, flow, dflow, offsets, n_off, H, W, pad, eps,           \
                         emit_value, scratch, out_val, out_tan, stream);                           \
  }                                                                                                \
  int evflow_fused_iwe_hvp_bwd_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const T* dflow,           \
                                        const double* offsets, int n_off, int H, int W, int pad,   \
                                        double eps, int term_a, const T* g1, const T* g2,          \
                                        T* dflow_out, void* stream) {                              \
    return launch_hvp_bwd<T>(EVFLOW_EVENT_ARGS, flow, dflow, offsets, n_off, H, W, pad, eps,       \
                             term_a, g1, g2, dflow_out, stream);                                   \
  }                                                                                                \
  int evflow_fused_iwe_fwd_acc_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const double* offsets,    \
                                        int n_off, int include_orig, int H, int W, int pad,        \
                                        int count, double eps, long long* acc, void* stream) {     \
    return launch_fwd_acc<T>(EVFLOW_EVENT_ARGS, flow, offsets, n_off, include_orig, H, W, pad,     \
                             count, eps, acc, stream);                                             \
  }                                                                                                \
  int evflow_fused_iwe_from_fixed_##SUFFIX(const long long* acc, int n_out, T* out, void* stream) {\
    return launch_from_fixed<T>(acc, n_out, out, stream);                                          \
  }                                                                                                \
  int evflow_fused_iwe_jvp_bound_##SUFFIX(EVFLOW_EVENTS(T), const T* dflow, const double* offsets, \
                                          int n_off, int H, int W, long long* bound,               \
                                          void* stream) {                                          \
    return launch_jvp_bound<T>(EVFLOW_EVENT_ARGS, dflow, offsets, n_off, H, W, bound, stream);     \
  }                                                                                                \
  int evflow_fused_iwe_jvp_acc_##SUFFIX(EVFLOW_EVENTS(T), const T* flow, const T* dflow,           \
                                        const double* offsets, int n_off, int H, int W, int pad,   \
                                        double eps, int emit_value, int unit_events,               \
                                        const long long* bound, long long* acc_val,                \
                                        long long* acc_tan, void* stream) {                        \
    return launch_jvp_acc<T>(EVFLOW_EVENT_ARGS, flow, dflow, offsets, n_off, H, W, pad, eps,       \
                             emit_value, unit_events, bound, acc_val, acc_tan, stream);            \
  }                                                                                                \
  int evflow_fused_iwe_from_scaled_##SUFFIX(const long long* acc_tan, const long long* acc_val,    \
                                            int n_out, const long long* bound, int unit_events,    \
                                            T* out_tan, T* out_val, void* stream) {                \
    return launch_from_scaled<T>(acc_tan, acc_val, n_out, bound, unit_events, out_tan, out_val,    \
                                 stream);                                                          \
  }

extern "C" {

int evflow_max_offsets() { return kMaxOffsets; }

EVFLOW_ENTRY_POINTS(float, f32)
EVFLOW_ENTRY_POINTS(double, f64)

}  // extern "C"
