"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: bf16 on the tensor cores, FLOP/s.
BF16_FLOPS_PER_S = 989e12
#: float32 on the CUDA cores, FLOP/s. No int32 rate is published; 128
#: float32 lanes an SM against 64 int32 lanes (plus IMAD on the float32
#: lanes) make this an assumed ceiling above the real int32 rate, so a
#: share taken against it reads low and never above 100 %.
INT32_OPS_PER_S = 67e12
#: HBM3, bytes/s.
HBM_BYTES_PER_S = 3.35e12
