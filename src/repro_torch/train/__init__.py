"""LM training in plain PyTorch: ``optimizer`` (AdamW, in place),
``train_step`` (loss → grads → AdamW, microbatches), ``checkpoint`` (the
reference's on-disk format), ``compress`` (int8 error-feedback
all-reduce) and ``minipack`` (the manifest's msgpack)."""
