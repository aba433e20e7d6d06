"""Attention kernels written by hand for Hopper (``csrc/*.cu``), each with a
plain PyTorch version beside it. ``kernels`` builds and loads them."""
