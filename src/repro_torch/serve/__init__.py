from repro_torch.serve.engine import KVServeEngine, ServeEngine, ServeStats  # noqa: F401
