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
// one thread takes one (image, event) pair of a batched call and adds its
// four corner votes, so every image of a call (the init sweep's P patches
// x K candidates, or one full-frame metric image) is voted in ONE launch.
//
// Contract, for events [n_img, n, 4] (x = row, y = column; the other two
// columns are not read) and weights [n_img * n] (or one scalar weight):
// image i of [n_img, H, W] is the sum over the events of image i of the
// bilinear votes of fixed_point.cuh: corners at floor(c + eps) and +1,
// corners outside the image dropped, zero-weight (padded) events and NaN
// positions skipped.  The sums are int64 fixed point (2^-36 units, integer
// atomics, one conversion pass), so the images are the same bits on every
// run.  Built with -fmad=false, the corner weights round like the plain
// PyTorch version's separate elementwise ops; the two then differ only by
// summation order and the fixed-point rounding (at most 2^-37 per vote).
//
// What bounds it on the H100: the scattered 8-byte atomic adds, four per
// voting event, and the 16-byte event read (the x, y pair shares its 32-byte
// sector with the unread columns); a few dozen FLOPs per event.  Nothing is
// staged in shared memory yet (a per-image accumulator in shared memory
// would turn the atomics into shared-memory adds for the sweep's small
// patch images).

#include "fixed_point.cuh"

namespace {

template <typename T>
__global__ void bilinear_vote_kernel(const T* __restrict__ events, const T* __restrict__ weight,
                                     T weight_scalar, int n_total, int n, int H, int W, T eps,
                                     unsigned long long* __restrict__ acc) {
  const int hw = H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_total; i += gridDim.x * blockDim.x) {
    const T w = weight == nullptr ? weight_scalar : weight[i];
    if (w == T(0)) continue;
    vote(acc + static_cast<long long>(i / n) * hw, events[4 * static_cast<long long>(i)],
         events[4 * static_cast<long long>(i) + 1], w, eps, H, W);
  }
}

// acc: zeroed int64 scratch of n_img * H * W; weight == nullptr votes every
// event with weight_scalar.
template <typename T>
int launch_vote(const T* events, const T* weight, double weight_scalar, int n_img, int n, int H,
                int W, double eps, long long* acc, T* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_total = n_img * n;
  if (n_total > 0) {
    bilinear_vote_kernel<T><<<grid_for(n_total), kThreads, 0, s>>>(
        events, weight, static_cast<T>(weight_scalar), n_total, n, H, W, static_cast<T>(eps),
        reinterpret_cast<unsigned long long*>(acc));
  }
  const int n_out = n_img * H * W;
  if (n_out > 0) from_fixed_kernel<T><<<grid_for(n_out), kThreads, 0, s>>>(acc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: one entry point per type.
extern "C" {

int evflow_vote_f32(const float* events, const float* weight, double weight_scalar, int n_img,
                    int n, int H, int W, double eps, long long* acc, float* out, void* stream) {
  return launch_vote<float>(events, weight, weight_scalar, n_img, n, H, W, eps, acc, out, stream);
}

int evflow_vote_f64(const double* events, const double* weight, double weight_scalar, int n_img,
                    int n, int H, int W, double eps, long long* acc, double* out, void* stream) {
  return launch_vote<double>(events, weight, weight_scalar, n_img, n, H, W, eps, acc, out, stream);
}

}  // extern "C"
