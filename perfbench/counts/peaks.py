"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit). A share of a peak is stated against
these, with the card's power limit printed beside it."""

FP32_FLOPS = 67e12        # float32 on the CUDA cores
TF32_FLOPS = 495e12       # TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_time(ops: float, nbytes: float, flops_peak: float) -> float:
    """Seconds the card needs at least: the larger of the operations over
    the arithmetic peak and the bytes over the memory peak."""
    return max(ops / flops_peak, nbytes / HBM_BYTES_PER_S)
