"""The paper's figure benchmarks on the port (``benchmarks/`` holds the
reference's). ``python -m repro_torch.bench.run --only fig11,...``."""
