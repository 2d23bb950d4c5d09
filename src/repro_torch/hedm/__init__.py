"""The paper's application: NF-HEDM stage 1 (on the hedm_reduce kernel) and
stage 2 (orientation fitting in PyTorch), and the interactive workflow."""
