"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), copied from the port's
``experiments/common.py``; the yardstick's rooflines divide by these."""

HBM_BYTES_PER_S = 3.35e12     # 80 GB HBM3
FP32_FLOPS = 67e12            # float32 outside the tensor cores
