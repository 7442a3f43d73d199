"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit). The port computes in float32 with TF32
off, so its arithmetic peak is the float32 rate outside the tensor
cores."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float):
    """(seconds, "bytes" or "operations"): the least time the card needs
    to move n_bytes and to compute n_ops, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
