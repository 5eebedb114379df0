from repro_torch.serve.engine import KVServeEngine  # noqa: F401
