"""Kernel classes and the device's busy time, a frozen copy of
``segmif_tpu_torch/profile_serving.py``'s ``CLASSES``, ``kernel_class``
and ``busy_us``."""
from __future__ import annotations

# kernel class: substrings of the kernel's name, first match wins
CLASSES = (
    ("DRDB int8 kernels", ("int8_entry_kernel", "int8_conv_kernel",
                           "int8_tail_kernel")),
    ("sr-attention kernel", ("sr_attention_kernel",)),
    ("FFM kernels", ("ffm_",)),
    ("DRDB growth kernel", ("growth_",)),  # growth_kernel<...>
    ("DRDB tail kernel", ("tail_kernel",)),
    ("LayerNorm", ("layer_norm",)),
    ("bilinear resize", ("upsample_bilinear",)),
    ("concat", ("CatArrayBatchedCopy",)),
    ("reduce", ("reduce_kernel",)),
    ("cuDNN convs", ("fprop", "conv2d", "cudnn", "implicit_gemm")),
    ("elementwise", ("elementwise_kernel",)),
)


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total
