"""Operator and doc tools on the port: ``python -m
repro_torch.tools.obstool``, ``.check_docs`` and ``.mk_tables``."""
