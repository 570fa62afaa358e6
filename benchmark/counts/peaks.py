"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of a peak
is stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
# operations a second by the precision a term runs in
FLOPS_PER_S = {
    "fp32": 67e12,  # float32 outside the tensor cores (TF32 off)
    "bf16": 989e12,
}
