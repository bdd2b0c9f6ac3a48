"""Map serialization: save and load the whole MapState.

Port of `orb_slam2_e_tpu/utils/map_io.py`, in the same npz format (format
version 3, one `map_<field>` array per MapState field, `extra_<key>` arrays
beside them), so that a map written by either package loads in the other.
The map IS arrays, so the round trip is lossless.

The version-1 migration backfills `next_seq` with the number of valid
keyframes, as the reference does. Where a keyframe had been culled before
the save, that is below the largest backfilled `kf_seq` plus one, so the
next keyframe can repeat a sequence id. Reproduced as it is, so that both
packages load an old file into the same state
(tests/test_torch_map_io.py::test_v1_migration_matches_reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.map_state import MapState

FORMAT_VERSION = 3   # v2: + kf_seq / next_seq / lm_first_seq
                     # v3: + lm_angle (rotation-consistency histograms)


def save_map(path, state: MapState, extra: dict | None = None):
    """Write the complete map to an .npz file."""
    arrays = {f"map_{k}": v.detach().cpu().numpy()
              for k, v in state._asdict().items()}
    arrays["format_version"] = np.asarray(FORMAT_VERSION)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path, *, device) -> tuple[MapState, dict]:
    """Load a map file -> (MapState on `device`, {extra key: numpy array})."""
    with np.load(path) as data:
        ver = int(data["format_version"])
        if ver > FORMAT_VERSION:
            raise ValueError(
                f"map checkpoint version {ver} > {FORMAT_VERSION}")
        fields = {k: data[f"map_{k}"] for k in MapState._fields
                  if f"map_{k}" in data.files}
        extra = {k[6:]: data[k] for k in data.files
                 if k.startswith("extra_")}
    if ver == 1:
        # v1 -> v2: slot order was insertion order before compaction
        # existed, so it backfills kf_seq faithfully
        kf_valid = fields["kf_valid"]
        fields.setdefault("kf_seq", np.where(
            kf_valid, np.arange(len(kf_valid)), -1).astype(np.int32))
        fields.setdefault("next_seq", np.int32(kf_valid.sum()))
        fields.setdefault("lm_first_seq",
                          np.zeros(fields["lm_valid"].shape, np.int32))
    if ver < 3:
        # zero is a safe backfill: the rotation histogram then votes on
        # -frame_angle, still one consistent bin
        fields.setdefault("lm_angle",
                          np.zeros(fields["lm_valid"].shape, np.float32))
    missing = [k for k in MapState._fields if k not in fields]
    if missing:
        raise ValueError(f"map checkpoint missing fields: {missing}")
    return MapState(**{k: torch.from_numpy(np.asarray(v)).to(device)
                       for k, v in fields.items()}), extra


def export_pointcloud_txt(path, state: MapState):
    """Plain-text xyz dump of the valid landmarks (the reference writes a
    3D point text dump next to its binary map, System.cc:595-634)."""
    xyz = state.lm_xyz[state.lm_valid].cpu().numpy()
    with open(path, "w") as f:
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
