"""The reference's examples (``examples/``) on the port:
``python -m repro_torch.examples.<name> [--device cpu]``."""
