"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
reference package, each beside its plain PyTorch version. Sources live in
``repro_torch/csrc`` and build at first use (`repro_torch.kernels._build`)."""
