"""The language models in plain PyTorch: configs come from
:mod:`repro_torch.configs`; ``layers`` and ``model`` hold the math,
``kvcache`` the REMIX-indexed prefix cache, ``convert`` carries the
reference's params across, ``sharding`` the logical-axis rule table."""
