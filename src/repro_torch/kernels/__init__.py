"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and the dispatch by
tensor device (``ops``)."""
