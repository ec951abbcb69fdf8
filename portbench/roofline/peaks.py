"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): HBM3 at 3.35 TB/s; float64 67 TFLOP/s on the
tensor cores (34 on the vector units); float32 67 TFLOP/s on the vector
units.  A bound is taken against the highest rate the chip offers for the
type, so that no kernel can beat it."""
BYTES_PER_S = 3.35e12
FLOPS = {"float64": 67e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of operations over the
    peak rate and bytes over the memory rate."""
    return max(ops / FLOPS[dtype], nbytes / BYTES_PER_S)
