"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit).  A roofline share is stated
against them, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12     # HBM3
FP32_FLOP_PER_S = 67e12       # float32 on the CUDA cores
TF32_FLOP_PER_S = 495e12      # TF32 on the tensor cores
MEMORY_BYTES = 80e9


def bound_seconds(flops, n_bytes):
    """``(seconds, "bytes" | "arithmetic")``: the least time the card
    could take for ``flops`` float32 operations and ``n_bytes`` moved."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "arithmetic")
