"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit)."""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_time(ops_at_peak, bytes_moved):
    """The least seconds for work given as [(operations, peak rate)] and
    the bytes moved: the larger of the compute and the memory bound."""
    compute = sum(n / rate for n, rate in ops_at_peak)
    return max(compute, bytes_moved / HBM_BYTES_PER_S)
