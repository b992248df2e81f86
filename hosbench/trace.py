"""Reading a `torch.profiler` trace of a span of steps: the device's busy
time (the union of its kernels' intervals), each kernel group's device
time, and the longest idle gaps.

The groups are a frozen copy of the port's `tools/common.py::GROUPS`,
`HUMAN_KERNELS`, `CONV_KEYS` and `GEMM_KEYS` (kernel names, lower case),
with the human kernels split by kernel (B1-B5; `bin_colscan_kernel`
added to B5), NCCL's kernels taken out of the glue as their own group,
and each memset that the next device operation's B kernel asks for (B4
and B5 zero their accumulators so) counted with that kernel. What is
left is the glue: every library kernel, copy and memset that is not a
GEMM, a convolution, Adam's or NCCL's."""

from __future__ import annotations

from typing import Dict, List, Tuple

B_KERNELS = {
    "B1": ("inv_image_kernel", "inv_fwd_kernel"),
    "B4": ("inv_gmax_kernel", "inv_bwd_kernel", "inv_fold_kernel"),
    "B5": ("build_image_kernel", "shared_blend_fwd_kernel",
           "bin_count_kernel", "bin_scan_kernel", "bin_colscan_kernel",
           "bin_scatter_kernel", "tap_bwd_kernel", "tap_finish_kernel"),
    "B2": ("embed_trunk_bf16", "embed_trunk_x3"),
    "B3": ("rows_bwd_bf16", "dw_bf16", "rows_bwd_x3", "dw_x3", "slot_sums"),
}
HUMAN_KERNELS = tuple(k for ks in B_KERNELS.values() for k in ks)
CONV_KEYS = ("conv", "implicit", "cudnn", "dgrad", "wgrad", "fprop")
GEMM_KEYS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
GROUPS = ("human", "adam", "conv_bf16", "conv_f32", "gemm", "nccl", "glue")


def group_of(name: str) -> str:
    n = name.lower()
    if any(k in n for k in HUMAN_KERNELS):
        return "human"
    if "nccl" in n:
        return "nccl"
    if "multi_tensor_apply" in n or "adam" in n:
        return "adam"
    if any(k in n for k in CONV_KEYS):
        return "conv_bf16" if "bf16" in n or "bfloat16" in n else "conv_f32"
    if any(k in n for k in GEMM_KEYS):
        return "gemm"
    return "glue"


def b_kernel_of(name: str):
    n = name.lower()
    for b, keys in B_KERNELS.items():
        if any(k in n for k in keys):
            return b
    return None


def _memset(name: str) -> bool:
    return name.lower().startswith("memset")


def device_events(prof) -> List[Tuple[float, float, str]]:
    """[(start s, end s, name)] of the device's kernels, copies and sets."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        out.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                    e.name))
    return sorted(out)


def summarize(events: List[Tuple[float, float, str]]) -> Dict:
    """busy seconds (union of intervals), seconds by group and by B
    kernel, the 10 longest kernels by name and the 10 longest gaps (named
    by the kernel that ends them)."""
    busy, groups, bk, by_name, gaps = 0.0, dict.fromkeys(GROUPS, 0.0), {}, \
        {}, []
    cur_s = cur_e = None
    for j, (s, e, name) in enumerate(events):
        d = e - s
        b = b_kernel_of(name)
        k = j
        while b is None and k < len(events) and _memset(events[k][2]):
            k += 1              # memsets that a B kernel's launch opens
            b = b_kernel_of(events[k][2]) if k < len(events) else None
        g = "human" if b else group_of(name)
        groups[g] += d
        if b:
            bk[b] = bk.get(b, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, reverse=True)[:10]
    return {"busy_s": busy, "groups": groups, "b_kernels": bk,
            "device_ops": [[n[:120], t] for n, t in top],
            "idle_gaps": [[f"before {n[:110]}", t] for t, n in gaps]}
