"""The reference's examples on the port, each a ``main(device=...)`` that
returns what it prints: ``python -m repro_torch.examples.<name> --device
cpu``."""
