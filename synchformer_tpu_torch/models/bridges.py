"""Projection bridges (synchformer_tpu/models/bridges.py::LinearBridge, which
the reference configs name ``torch.nn.Linear``): the 768 -> 768 audio and
video projections and the offset head."""
from __future__ import annotations

from synchformer_tpu_torch.models.layers import Linear


class LinearBridge(Linear):
    """Plain Linear projection with flax Dense numerics; state names
    ``weight``, ``bias``."""
