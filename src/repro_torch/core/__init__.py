"""REMIX core: multiword keys, sorted runs, the REMIX index and query engine.

Public API:
  - :func:`repro_torch.core.remix.build_remix` — build a Remix over runs
  - :mod:`repro_torch.core.query` — batched seek / scan / get (paper §3)
  - :mod:`repro_torch.core.merge_iter` — merging-iterator baseline (§2)
  - :mod:`repro_torch.core.bloom` — bloom-filter baseline
"""
from repro_torch.core import keys, bloom, merge_iter, query, runs, view  # noqa: F401
from repro_torch.core.remix import Remix, build_remix  # noqa: F401
from repro_torch.core.runs import Run, RunSet, make_run, stack_runs  # noqa: F401
