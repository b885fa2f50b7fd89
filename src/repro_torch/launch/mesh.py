"""Device constants of the roofline terms.

Counterpart of ``repro.launch.mesh``, which holds the TPU v5e's figures
(197 TFLOP/s bf16, 819 GB/s) beside its mesh constructors.  The port
runs on one NVIDIA H100 SXM, and these are its datasheet figures (per
card, 700 W): the dense bf16 tensor-core peak and the HBM3 rate.  They
are the card's published peaks, not a measurement.
"""

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense (no sparsity)
HBM_BW = 3.35e12                  # B/s
