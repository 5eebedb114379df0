"""Operator tools on the port: ``python -m repro_torch.tools.obstool``."""
