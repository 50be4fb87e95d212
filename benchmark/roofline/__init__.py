"""Each hand kernel's least time from the problem's shapes, whatever
implements it, against the published peaks of one NVIDIA H100 SXM (dense,
at its 700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
tensor cores, and the special-function units' exponentials, 132 SMs x 16 a
clock at 1.98 GHz. Frozen copies of ``chip_smoke.py``'s ``sums_bound_ms``
(without ``layout``) and ``qs_bound``, with the window and disk offsets
worked out here."""
HBM_BYTES_PER_MS = 3.35e9
FP32_OPS_PER_MS = 67e9
SFU_OPS_PER_MS = 132 * 16 * 1.98e6
