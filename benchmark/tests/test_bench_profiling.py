"""The traced slice's attribution of device time to the fused warp+vote
library: kernel identifiers from the profiler's names, the kernels each
CUDA library defines, and the conversion kernel both share."""

import numpy as np

from benchmark import harness, profiling


def test_kernel_id_strips_namespace_templates_and_arguments():
    assert profiling.kernel_id("void (anonymous namespace)::fused_iwe_grad_kernel<float, true>(GradArgs<float>, "
                               "float*)") == "fused_iwe_grad_kernel"
    assert profiling.kernel_id("void at::native::vectorized_elementwise_kernel<4, float>(int, float)") \
        == "vectorized_elementwise_kernel"
    assert profiling.kernel_id("indexing_backward_kernel_stride_1") == "indexing_backward_kernel_stride_1"


def test_each_library_names_its_own_kernels_and_its_headers():
    fused, vote = set(harness.kernel_names("fused_iwe.cu")), set(harness.kernel_names("vote.cu"))
    assert {"fused_iwe_fwd_kernel", "fused_iwe_grad_kernel", "fused_iwe_jvp_kernel"} <= fused
    assert {"bilinear_vote_kernel", "bilinear_vote_shared_kernel"} <= vote
    assert not ({"bilinear_vote_kernel", "bilinear_vote_shared_kernel"} & fused)
    assert fused & vote == {"from_fixed_kernel"}  # fixed_point.cuh, included by both


def test_the_shared_conversion_goes_to_the_kernel_before_it_on_its_stream():
    names = ["fused_iwe_fwd_kernel", "from_fixed_kernel", "bilinear_vote_kernel", None, "add_kernel"]
    fused, vote = ["fused_iwe_fwd_kernel", "from_fixed_kernel"], ["bilinear_vote_kernel", "from_fixed_kernel"]
    # stream 7: fwd, convert (fused), vote, convert (K8's), a copy, convert (still K8's), add, convert
    # (neither's: after a kernel of no library); stream 8: fwd, whose convert runs on stream 8
    ids = [0, 1, 2, 1, 3, 1, 4, 1, 0, 1]
    streams = [7, 7, 7, 7, 7, 7, 7, 7, 8, 8]
    starts = [0, 1, 2, 3, 4, 5, 6, 7, 2, 8]
    got = profiling.fused_mask(ids, streams, starts, names, fused, vote)
    np.testing.assert_array_equal(got, [True, True, False, False, False, False, False, False, True, True])
