"""The LM substrate as far as serving needs it: layers, GQA attention,
Mamba2, the uniform and zamba_hybrid stacks, the model, and the converter
from the reference package's parameters. Full-sequence attention and the
SSD scan go through `repro_torch.kernels.ops`."""
