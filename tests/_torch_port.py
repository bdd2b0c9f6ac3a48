"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference (tests/test_torch_*.py). Both packages run on the CPU; data passes
between them as numpy arrays."""

import numpy as np
import pytest
import torch

# the suite runs several pytest workers at once: keep each one's torch
# thread pool small
torch.set_num_threads(2)


def jnp_dict(nt) -> dict:
    """A JAX NamedTuple -> {field: numpy array}."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def tnp(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def cuda_device():
    """The CUDA device for tests of kernels that only run on the card;
    skips (decided at run time, never at import) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def as_jax(cls, arrays: dict):
    """{field: numpy array} -> the reference's NamedTuple `cls`."""
    import jax.numpy as jnp
    return cls(**{k: jnp.asarray(arrays[k]) for k in cls._fields})


def ulp_moved(a, rng) -> np.ndarray:
    """Each float32 entry moved by -1, 0 or +1 ulp."""
    a = np.asarray(a, np.float32)
    step = rng.randint(-1, 2, a.shape)
    up = np.nextafter(a, np.float32(np.inf))
    down = np.nextafter(a, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, a))


# ---------------------------------------------------------------------------
# The deformable mode's scenes, built once as numpy and handed to both
# packages: the constructions of tests/test_deformable.py and
# tests/test_reloc_kpi.py
# ---------------------------------------------------------------------------

DEFORMED_CAM = dict(fx=400.0, fy=400.0, cx=240.0, cy=180.0, width=480,
                    height=360)


def deformed_problem(n_grid=9, defmag=0.25, seed=0, noise=0.3) -> dict:
    """tests/test_deformable.py::build_deformed_problem: the grid map at
    rest under two keyframes, and a frame BOUND to it that sees the surface
    deformed along z from a known pose. Numpy arrays (see
    `synthetic.deformed_grid_map`), `frame` bound."""
    from orb_slam2_e_tpu_torch.utils.synthetic import deformed_grid_map
    a = deformed_grid_map(n_grid=n_grid, defmag=defmag, tang=0.0, seed=seed,
                          noise=noise, max_keyframes=8, max_features=128,
                          max_points=256)
    pid = a["frame"]["point_ids"].copy()
    pid[:a["n"]] = np.arange(a["n"])
    a["frame"] = dict(a["frame"], pose7=a["pose7_true"], point_ids=pid)
    return a


def _package(package: str):
    if package == "jax":
        from orb_slam2_e_tpu.models import system, kf_database
        from orb_slam2_e_tpu.models.frame import Frame
        from orb_slam2_e_tpu.models.map_state import MapState
        from orb_slam2_e_tpu.ops import bow
        from orb_slam2_e_tpu.ops.camera import Camera
        return system, kf_database, Frame, MapState, bow, Camera
    from orb_slam2_e_tpu_torch.models import system, kf_database
    from orb_slam2_e_tpu_torch.models.frame import Frame
    from orb_slam2_e_tpu_torch.models.map_state import MapState
    from orb_slam2_e_tpu_torch.ops import bow
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    return system, kf_database, Frame, MapState, bow, Camera


def deformed_system_arrays(n_grid=13, n_features=200, n_levels=2,
                           max_keyframes=8, max_points=512, **field) -> dict:
    """The numpy side of tests/test_reloc_kpi.py::build_deformed_system."""
    from orb_slam2_e_tpu_torch.ops.orb import level_quotas
    from orb_slam2_e_tpu_torch.utils.synthetic import deformed_grid_map
    a = deformed_grid_map(
        n_grid=n_grid, max_keyframes=max_keyframes, max_points=max_points,
        max_features=sum(level_quotas(n_features, 1.2, n_levels)), **field)
    a["cfg"] = dict(max_keyframes=max_keyframes, max_points=max_points,
                    n_features=n_features, n_levels=n_levels)
    return a


def deformed_system(package: str, arrays: dict, stats_path=None, **cfg):
    """tests/test_reloc_kpi.py::build_deformed_system in `package` ("jax"
    or "torch", on the CPU) from `deformed_system_arrays`: a LOST system in
    deformable mode that holds the two-keyframe map, a vocabulary trained
    on the landmark descriptors and the recognition database, and the
    unbound query frame. Returns (system, frame)."""
    system, kfdb, Frame, MapState, bow, Camera = _package(package)
    jax_side = package == "jax"
    kw = {} if jax_side else dict(device="cpu")
    cfg = dict(dict(arrays["cfg"], deformable=True, el_type=1,
                    pipeline=False,
                    stats_reloc_path=stats_path and str(stats_path)), **cfg)
    s = system.SlamSystem(Camera.create(**DEFORMED_CAM),
                          system.SystemConfig(**cfg),
                          system.Sensor.MONOCULAR, **kw)
    if jax_side:
        import jax
        s.map = as_jax(MapState, arrays["map"])
        frame = as_jax(Frame, arrays["frame"])
        voc = bow.train_vocabulary(arrays["desc"], k=8, L=2, iters=3)
        s.vocab = voc
        s._bow_jit = jax.jit(lambda d, v: bow.bow_vector(
            voc, bow.transform(voc, d, v)[0], v))
        s.bow_db = kfdb.BowDatabase.create(cfg["max_keyframes"], voc.n_words)
    else:
        from orb_slam2_e_tpu_torch.utils import convert
        s.map = convert.map_state_from_numpy(arrays["map"], "cpu")
        frame = convert.frame_from_numpy(arrays["frame"], "cpu")
        s._set_vocab(bow.train_vocabulary(arrays["desc"], k=8, L=2, iters=3,
                                          device="cpu"))
    s.n_keyframes = 2
    s.last_kf_slot = 1
    s.state = system.TrackState.LOST
    for slot in (0, 1):
        s._db_add(slot)
    return s, frame
