"""Operations and bytes of the work the port is asked to do, counted from
shapes and inputs by the benchmark itself, so a count reads the same work
whatever implements it."""

# published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12
