"""NVIDIA H100 SXM data-sheet peaks (dense, at the full 700 W power limit),
the yardstick of every roofline and utilization share.  The GNN trains in
float32 with TF32 off, so its products run outside the tensor cores.
Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` and
``FP32_FLOP_PER_S``."""

HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
