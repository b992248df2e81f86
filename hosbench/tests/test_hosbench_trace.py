"""The reading of a profiled span (`hosbench/trace.py`): every kernel of
the port's hand-written B1-B5 counted with its kernel, the memsets a B
kernel's launch opens counted with it, busy time as the union of the
device's intervals, and the rest in their library groups.

    python -m pytest -q hosbench/tests/test_hosbench_trace.py
"""

import os
import re

import pytest

from hosbench import trace

CSRC = os.path.join(os.path.dirname(__file__), "..", "..",
                    "hosnerf_tpu_torch", "csrc")
STEP_SOURCES = ("lbs_forward.cu", "lbs_inverse.cu", "trunk_common.cuh",
                "embed_trunk_bwd.cu")
OFF_THE_STEP = ("shared_weights_fwd_kernel",)   # row 7: `bone_weights` only


def kernels_of(path):
    with open(path) as f:
        src = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", f.read())
    return set(re.findall(r"__global__[^(]*?\b(\w+)\s*\(", src))


@pytest.mark.parametrize("source", STEP_SOURCES)
def test_every_hand_written_kernel_has_its_b_group(source):
    path = os.path.join(CSRC, source)
    if not os.path.exists(path):
        pytest.skip(f"{source} not in this checkout")
    names = kernels_of(path) - set(OFF_THE_STEP)
    assert names
    for n in names:
        assert trace.b_kernel_of(f"void (anonymous namespace)::{n}<128>(")\
            is not None, n


def test_memsets_opened_by_a_b_kernel_count_with_it():
    ev = [(0.0, 1.0, "Memset (Device)"), (1.0, 2.0, "Memset (Device)"),
          (2.0, 3.0, "void bin_count_kernel(int)"),
          (3.0, 4.0, "Memset (Device)"),
          (4.0, 5.0, "void at::native::elementwise_kernel<128>"),
          (6.0, 7.0, "nvjet_tst_256x128"), (6.5, 8.0, "Memset (Device)")]
    r = trace.summarize(ev)
    assert r["b_kernels"] == {"B5": 3.0}
    assert r["groups"]["human"] == 3.0
    assert r["groups"]["glue"] == 1.0 + 1.0 + 1.5
    assert r["groups"]["gemm"] == 1.0
    assert r["busy_s"] == pytest.approx(7.0)
    assert r["idle_gaps"][0][1] == pytest.approx(1.0)


@pytest.mark.parametrize("name,group", [
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel",
     "adam"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32", "conv_bf16"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32", "conv_f32"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::vectorized_elementwise_kernel<4>", "glue"),
])
def test_library_groups(name, group):
    assert trace.group_of(name) == group
