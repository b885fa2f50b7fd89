"""TailBench++ on PyTorch and CUDA: the port of ``repro`` to an NVIDIA
H100.

Two slices are ported: the vector grid runtime (``repro_torch.vector``:
whole sweep grids advanced as one array program, with the slot scan and
the fused p50/p95/p99 head as CUDA C++ kernels), and real-model serving
(``repro_torch.models``, ``repro_torch.serving``,
``repro_torch.launch.serve``: open-loop clients through the balancer to
continuous-batching engines of a dense attention LM, with flash
attention for prefill and flash decode as CUDA C++ kernels).  The
kernels are written for Hopper (``repro_torch.kernels``).  Entry points
run on the card by default and on the CPU only when asked
(``device="cpu"``).  The package imports nothing of ``repro`` and never
imports JAX.
"""
