"""State carried across between the JAX reference and the port.

SLAM has no learned weights; its parameters are the camera, the ORB test
pattern (bit-identical by construction) and the map state. The camera, a
frame, a map and extractor output cross as dicts of numpy arrays keyed by
the reference's field names, e.g.

    {k: np.asarray(v) for k, v in jax_state._asdict().items()}

Dtypes and shapes are kept field by field (uint8 descriptors, int8
`lm_rigid`, 0-d int32 `next_seq`), so a round trip is bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.frame import Frame
from ..models.map_state import MapState
from ..ops.camera import Camera
from ..ops.orb import OrbFeatures


def _tensors(cls, arrays: dict, device):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{k: torch.from_numpy(np.array(arrays[k], copy=True)).to(
        device) for k in cls._fields})


def camera_from_numpy(arrays: dict, device) -> Camera:
    return _tensors(Camera, arrays, device)


def frame_from_numpy(arrays: dict, device) -> Frame:
    return _tensors(Frame, arrays, device)


def map_state_from_numpy(arrays: dict, device) -> MapState:
    return _tensors(MapState, arrays, device)


def features_from_numpy(arrays: dict, device) -> OrbFeatures:
    return _tensors(OrbFeatures, arrays, device)


def to_numpy(state) -> dict:
    """Any of the NamedTuples above -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
