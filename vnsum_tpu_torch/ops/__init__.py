"""Kernels written by hand for Hopper (``csrc/*.cu``): the attention kernels
and the int8-weight GEMV, each with a plain PyTorch version beside it.
``kernels`` builds and loads them."""
