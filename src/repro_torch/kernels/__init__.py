"""Hopper kernels for the REMIX hot path, with plain-torch oracles in ref.py.

  - selector_decode: in-group occurrence decode (paper §3.2)
  - anchor_search:   batched anchor index search
  - ops:             compositions of the kernels into seek/get/scan
  - device_view:     device residency manager + batched reads

Each kernel module's wrapper carries its launch count, e.g.
``repro_torch.kernels.anchor_search.anchor_search.launches``.
"""
from repro_torch.kernels import (  # noqa: F401
    anchor_search,
    device_view,
    ops,
    ref,
    selector_decode,
)
