"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It keeps the reference package's module paths and public names, so each
counterpart is found under the same path:

  repro_torch.core     -- the staging simulator (numpy, copied as it is).
  repro_torch.kernels  -- hand-written CUDA kernels for sm_90a, each with
                          its plain PyTorch version and a launch counter.
  repro_torch.hedm     -- the NF-HEDM pipeline: stage 1 on the kernel,
                          stage 2 in PyTorch; ``hedm.interactive`` runs the
                          paper's interactive workflow end to end.

The package imports torch and numpy and nothing of ``jax`` or ``repro``.
Entry points take ``device=`` and default to ``"cuda"``
(`repro_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
