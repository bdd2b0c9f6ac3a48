"""State carried across between the JAX reference and the port.

SLAM has no learned weights; its parameters are the camera, the ORB test
pattern (bit-identical by construction) and the map state. The camera, a
frame, a map, extractor output, the recognition database, a bundle-
adjustment problem with its PCG carry, the pose graph's arrays and a FEM
mesh cross as dicts of numpy arrays keyed by the reference's field (or
argument) names, e.g.

    {k: np.asarray(v) for k, v in jax_state._asdict().items()}

Dtypes and shapes are kept field by field (uint8 descriptors, int8
`lm_rigid`, 0-d int32 `next_seq`), so a round trip is bit for bit. Arrays
with a leading lane axis (the state of the reference's `BatchedTracker`)
cross the same way, into a NamedTuple of (B, ...) tensors; `stack_lanes`
and `unstack_lanes` go between B NamedTuples and one such stack.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.frame import Frame
from ..models.kf_database import BowDatabase
from ..models.map_state import MapState
from ..ops.ba import BAProblem
from ..ops.camera import Camera
from ..ops.fem import FemMesh
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


def bow_database_from_numpy(arrays: dict, device) -> BowDatabase:
    return _tensors(BowDatabase, arrays, device)


def ba_problem_from_numpy(arrays: dict, device) -> BAProblem:
    return _tensors(BAProblem, arrays, device)


# the carry of `ba.ba_pcg_chunk` and the arguments of
# `pose_graph.optimize_pose_graph`, in their order
PCG_CARRY_FIELDS = ("cam_pose7", "points", "lam")
POSE_GRAPH_FIELDS = ("sim8", "kf_valid", "fixed", "edges_i", "edges_j",
                     "meas8", "edge_valid")


def _tuple(fields, arrays: dict, device) -> tuple:
    missing = set(fields) - set(arrays)
    if missing:
        raise KeyError(f"fields missing: {sorted(missing)}")
    return tuple(torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
                 for k in fields)


def pcg_carry_from_numpy(arrays: dict, device) -> tuple:
    """{cam_pose7, points, lam} -> the (pose7, points, lambda) carry."""
    return _tuple(PCG_CARRY_FIELDS, arrays, device)


def pose_graph_from_numpy(arrays: dict, device) -> tuple:
    """{sim8, kf_valid, fixed, edges_i, edges_j, meas8, edge_valid} -> the
    positional arguments of the pose-graph optimizers."""
    return _tuple(POSE_GRAPH_FIELDS, arrays, device)


_MESH_STATIC = ("el_type", "h")      # Python values in both packages


def fem_mesh_from_numpy(arrays: dict, device) -> FemMesh:
    """{field: array, el_type: int, h: float} -> a FemMesh on `device`."""
    missing = set(FemMesh._fields) - set(arrays)
    if missing:
        raise KeyError(f"FemMesh fields missing: {sorted(missing)}")
    return FemMesh(
        **{k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
           for k in FemMesh._fields if k not in _MESH_STATIC},
        el_type=int(arrays["el_type"]), h=float(arrays["h"]))


def fem_mesh_to_numpy(mesh: FemMesh) -> dict:
    """A FemMesh -> {field: numpy array}, `el_type` and `h` as they are."""
    return {k: (v if k in _MESH_STATIC else v.detach().cpu().numpy())
            for k, v in mesh._asdict().items()}


def stack_lanes(nts):
    """B NamedTuples of one type -> one of (B, ...) tensors, field by field
    (the reference's `jax.tree.map(lambda *xs: jnp.stack(xs), *nts)`)."""
    return type(nts[0])(*(torch.stack(xs) for xs in zip(*nts)))


def unstack_lanes(nt) -> list:
    """A NamedTuple of (B, ...) tensors -> B NamedTuples of its lanes."""
    return [type(nt)(*xs) for xs in zip(*(v.unbind(0) for v in nt))]


def to_numpy(state) -> dict:
    """Any of the NamedTuples above -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
