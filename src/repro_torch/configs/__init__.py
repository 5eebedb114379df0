"""Configurations of the port.

Carried so far: the paper's own system config, ``remixdb``
(:class:`repro_torch.configs.remixdb.RemixServiceConfig`), which sizes
the sharded store of :mod:`repro_torch.db.sharded`. The reference's
language-model configs and its ``get_config`` / ``reduced`` registry come
with the models, which are not ported yet.
"""
from repro_torch.configs.remixdb import CONFIG, RemixServiceConfig  # noqa: F401
