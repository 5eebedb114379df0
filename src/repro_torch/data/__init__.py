from repro_torch.data.pipeline import DataPipeline  # noqa: F401
