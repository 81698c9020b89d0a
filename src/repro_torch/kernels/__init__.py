"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.  Sources live under each kernel's ``csrc/`` and are built
at first use by :mod:`repro_torch.kernels._build`."""
