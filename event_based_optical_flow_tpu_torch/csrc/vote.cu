// Standalone bilinear vote of weighted events into images (K8), for NVIDIA
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// event_based_optical_flow_tpu_torch/ops/vote.py.
//
// Replaces the Pallas TPU kernel of the JAX package
//   ops/pallas_iwe.py   _iwe_kernel / _iwe_forward (bilinear_vote_pallas,
//                       vmapped over a leading batch of event sets)
// The TPU kernel builds per-chunk corner-weight blocks [H, C] and [W, C] in
// VMEM and accumulates the image as their product on the matrix unit over a
// sequential grid.  That layout fed the MXU and is not the contract; here
// every image of a call (the init sweep's P patches x K candidates, or one
// full-frame metric image) is voted in ONE launch.
//
// Contract, for events (rows of [n, 4], image i reading row i / event_rep:
// [n_img / event_rep, n, 4]; x = row, y = column, the other two columns are
// not read) and weights (rows of n, image i reading row i / weight_rep:
// [n_img / weight_rep, n], or one scalar weight): image i of
// [n_img, H, W] is the sum over the events of image i of the bilinear votes
// of fixed_point.cuh: corners at floor(c + eps) and +1, corners outside the
// image dropped, zero-weight (padded) events and NaN positions skipped.  The
// sums are int64 fixed point (2^-36 units), so the images are the same bits
// on every run and on either path below.  With pad > 0 the images are the
// padded ones (H and W are their size) and each event votes at (x + pad, y +
// pad) (the JAX package's EventImageConverter with outer_padding; K8's
// Pallas form shifts the same way, pallas_iwe.py:169-170); with count each
// in-image corner gets w (count_vote) instead of the bilinear fraction.
// Built with -fmad=false, the corner
// weights round like the plain PyTorch version's separate elementwise ops;
// the two then differ only by summation order and the fixed-point rounding
// (at most 2^-37 per vote).
//
// Two paths, by image size:
// - An image of at most kSharedPixels pixels (every init-sweep call: the
//   MVSEC geometry's patches from 16x21 at the finest scale to 64x84 at
//   scale 2, DSEC's from 28x40 to 112x160) is summed by one block in shared
//   memory and written once as T: one launch, no scratch in device memory,
//   no conversion pass.  Up to kSmallPixels (48 KB of sums, the shared
//   memory a block gets without opting in) a block has 256 threads and
//   several share an SM; above it the kernel opts in to 227 KB and a block
//   of 1024 threads has the SM to itself.  The image's
//   events are contiguous, so no binning pass either.  A 64-bit shared
//   atomicAdd compiles to a compare-and-swap loop on sm_90 (1.7x slower on
//   the sweep's call, PERF.md), so each int64 sum is two 32-bit words: the
//   low word's atomicAdd returns its old value, and its carry goes with the
//   high half into the high word.  That is integer addition modulo 2^64 in
//   any order, the int64 sum's bits.
// - A larger image (a full-frame metric vote, 260x346: 720 KB of int64;
//   DSEC's 480x640) keeps global 64-bit atomics into a zeroed int64
//   scratch, one thread per (image, event), then a conversion pass.
//
// An event-sharded vote (the parallel: mesh's sharded_iwe and
// sharded_multifocal_loss) splits the call: each shard's vote writes its
// int64 sums into the caller's buffer (evflow_vote_acc: the shared path
// writes them in place of the images, the global path adds into the zeroed
// buffer and skips the conversion), the shards' sums are added as
// integers, and one conversion (evflow_vote_from_fixed) gives the unsharded
// call's bits.
//
// What bounds it on the H100: the scattered atomic adds, four per voting
// event (8-byte RED to device memory on the global path, shared-memory
// atomics on the other), and the 16-byte event read (the x, y pair shares
// its 32-byte sector with the unread columns); a few dozen FLOPs per event.

#include <atomic>

#include "fixed_point.cuh"

namespace {

// The shared-memory path's largest images: 8 bytes a pixel; 48 KB, the
// shared memory a block gets without opting in, and 227 KB, an H100
// block's most.
constexpr int kSmallPixels = 6144;
constexpr int kSharedPixels = 232448 / 8;
constexpr int kLargeThreads = 1024;

// The global path: one thread per (image, event); image i reads event row
// i / event_rep; weight == nullptr votes every event with weight_scalar,
// else image i reads weight row i / weight_rep.
template <typename T>
__global__ void bilinear_vote_kernel(const T* __restrict__ events, int event_rep, const T* __restrict__ weight,
                                     int weight_rep, T weight_scalar, int n_total, int n, int H, int W, int pad,
                                     int count, T eps, unsigned long long* __restrict__ acc) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_total; i += gridDim.x * blockDim.x) {
    const T w = weight == nullptr ? weight_scalar : weight[weight_rep == 1 ? i : (i / n / weight_rep) * n + i % n];
    if (w == T(0)) continue;
    const long long e = event_rep == 1 ? i : static_cast<long long>(i / n / event_rep) * n + i % n;
    vote(acc + static_cast<long long>(i / n) * hw, padded(events[4 * e], pad), padded(events[4 * e + 1], pad), w,
         eps, H, W, count);
  }
}

// Adds one vote in 2^-kFixBits units to the int64 sum held as the words
// lo[p], hi[p] (see the header).
template <typename T>
__device__ __forceinline__ void add_split(unsigned* lo, unsigned* hi, int p, T value) {
  const unsigned long long q =
      static_cast<unsigned long long>(__double2ll_rn(static_cast<double>(value) * kFixScale));
  const unsigned add_lo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(lo + p, add_lo);
  const unsigned add_hi = static_cast<unsigned>(q >> 32) + (old + add_lo < old ? 1u : 0u);
  if (add_hi != 0u) atomicAdd(hi + p, add_hi);
}

// fixed_point.cuh's vote into the split sums.
template <typename T>
__device__ __forceinline__ void vote_split(unsigned* lo, unsigned* hi, T xw, T yw, T wt, T eps, int H,
                                           int W, bool count) {
  int r0, c0;
  T fx, fy;
  if (!corners(xw, yw, eps, H, W, &r0, &c0, &fx, &fy)) return;
  const bool in_r0 = r0 >= 0, in_r1 = r0 + 1 < H;
  const bool in_c0 = c0 >= 0, in_c1 = c0 + 1 < W;
  if (in_r0 && in_c0) add_split(lo, hi, r0 * W + c0, count ? wt : (T(1) - fx) * (T(1) - fy) * wt);
  if (in_r1 && in_c0) add_split(lo, hi, (r0 + 1) * W + c0, count ? wt : fx * (T(1) - fy) * wt);
  if (in_r0 && in_c1) add_split(lo, hi, r0 * W + c0 + 1, count ? wt : (T(1) - fx) * fy * wt);
  if (in_r1 && in_c1) add_split(lo, hi, (r0 + 1) * W + c0 + 1, count ? wt : fx * fy * wt);
}

// One block per image: zero the image's sums in shared memory, vote its
// events, write the image as T (from_fixed_kernel's conversion), or with
// fixed the int64 sums themselves.
template <typename T, int Threads>
__global__ void __launch_bounds__(Threads)
    bilinear_vote_shared_kernel(const T* __restrict__ events, int event_rep, const T* __restrict__ weight,
                                int weight_rep, T weight_scalar, int n, int H, int W, int pad, int count, T eps,
                                T* __restrict__ out, long long* __restrict__ fixed) {
  extern __shared__ unsigned sums[];  // the low words [H * W], then the high words
  const int hw = H * W;
  unsigned* lo = sums;
  unsigned* hi = sums + hw;
  for (int p = threadIdx.x; p < 2 * hw; p += blockDim.x) sums[p] = 0u;
  __syncthreads();
  const long long img = blockIdx.x;
  const T* ev = events + 4 * (img / event_rep) * n;
  const T* w_row = weight == nullptr ? nullptr : weight + (img / weight_rep) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T w = w_row == nullptr ? weight_scalar : w_row[j];
    if (w == T(0)) continue;
    vote_split(lo, hi, padded(ev[4 * j], pad), padded(ev[4 * j + 1], pad), w, eps, H, W, count);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const long long sum = static_cast<long long>((static_cast<unsigned long long>(hi[p]) << 32) | lo[p]);
    if (fixed != nullptr) {
      fixed[img * hw + p] = sum;
    } else {
      out[img * hw + p] = static_cast<T>(static_cast<double>(sum) * kFixUnit);
    }
  }
}

// Image i reads event row i / event_rep; weight == nullptr votes every
// event with weight_scalar, else image i reads weight row i / weight_rep.  acc: zeroed int64 scratch of
// n_img * H * W for an image of more than kSharedPixels pixels, unused (may
// be null) otherwise.  A refused opt-in or launch is returned, never worked
// around.
// With fixed_only the int64 sums are the result (the event mesh's split):
// the shared path writes them into acc (which then needs no zeroing), the
// global path adds into the zeroed acc and converts nothing; out is unused.
template <typename T>
int launch_vote(const T* events, int event_rep, const T* weight, int weight_rep, double weight_scalar, int n_img,
                int n, int H, int W, int pad, int count, double eps, long long* acc, T* out, void* stream,
                bool fixed_only = false) {
  if (event_rep < 1 || (weight != nullptr && weight_rep < 1) || pad < 0 || (fixed_only && acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* fixed = fixed_only ? acc : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = H * W;
  if (n_img < 1 || hw < 1) return static_cast<int>(cudaGetLastError());
  const size_t smem = 2 * hw * sizeof(unsigned);
  if (hw <= kSmallPixels) {
    bilinear_vote_shared_kernel<T, kThreads><<<n_img, kThreads, smem, s>>>(
        events, event_rep, weight, weight_rep, static_cast<T>(weight_scalar), n, H, W, pad, count,
        static_cast<T>(eps), out, fixed);
    return static_cast<int>(cudaGetLastError());
  }
  if (hw <= kSharedPixels) {
    // the opt-in is a function attribute of each device's context: set once per device
    static std::atomic<unsigned long long> opted_in{0};  // one bit per device
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = 1ull << (device & 63);
    if (!(opted_in.load() & bit)) {
      e = cudaFuncSetAttribute(bilinear_vote_shared_kernel<T, kLargeThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedPixels * 2 * static_cast<int>(sizeof(unsigned)));
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in.fetch_or(bit);
    }
    bilinear_vote_shared_kernel<T, kLargeThreads><<<n_img, kLargeThreads, smem, s>>>(
        events, event_rep, weight, weight_rep, static_cast<T>(weight_scalar), n, H, W, pad, count,
        static_cast<T>(eps), out, fixed);
    return static_cast<int>(cudaGetLastError());
  }
  if (acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int n_total = n_img * n;
  if (n_total > 0) {
    bilinear_vote_kernel<T><<<grid_for(n_total), kThreads, 0, s>>>(
        events, event_rep, weight, weight_rep, static_cast<T>(weight_scalar), n_total, n, H, W, pad, count,
        static_cast<T>(eps), reinterpret_cast<unsigned long long*>(acc));
  }
  if (fixed_only) return static_cast<int>(cudaGetLastError());
  const int n_out = n_img * hw;
  from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: one entry point per type, and the shared-memory path's
// largest image.
extern "C" {

int evflow_vote_shared_pixels() { return kSharedPixels; }

int evflow_vote_f32(const float* events, int event_rep, const float* weight, int weight_rep, double weight_scalar,
                    int n_img, int n, int H, int W, int pad, int count, double eps, long long* acc, float* out,
                    void* stream) {
  return launch_vote<float>(events, event_rep, weight, weight_rep, weight_scalar, n_img, n, H, W, pad, count, eps,
                            acc, out, stream);
}

int evflow_vote_f64(const double* events, int event_rep, const double* weight, int weight_rep, double weight_scalar,
                    int n_img, int n, int H, int W, int pad, int count, double eps, long long* acc, double* out,
                    void* stream) {
  return launch_vote<double>(events, event_rep, weight, weight_rep, weight_scalar, n_img, n, H, W, pad, count, eps,
                             acc, out, stream);
}

// The event mesh's split (see the header): a shard's int64 sums into acc
// [n_img, H, W] (zeroed by the caller for an image of more than
// kSharedPixels pixels), and the conversion of n_out sums.
#define EVFLOW_VOTE_SPLIT(T, SUFFIX)                                                                         \
  int evflow_vote_acc_##SUFFIX(const T* events, int event_rep, const T* weight, int weight_rep,              \
                               double weight_scalar, int n_img, int n, int H, int W, int pad, int count,     \
                               double eps, long long* acc, void* stream) {                                   \
    return launch_vote<T>(events, event_rep, weight, weight_rep, weight_scalar, n_img, n, H, W, pad, count,  \
                          eps, acc, nullptr, stream, true);                                                  \
  }                                                                                                          \
  int evflow_vote_from_fixed_##SUFFIX(const long long* acc, int n_out, T* out, void* stream) {               \
    if (n_out > 0) {                                                                                         \
      from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(acc, n_out,  \
                                                                                                out);        \
    }                                                                                                        \
    return static_cast<int>(cudaGetLastError());                                                             \
  }

EVFLOW_VOTE_SPLIT(float, f32)
EVFLOW_VOTE_SPLIT(double, f64)

}  // extern "C"
