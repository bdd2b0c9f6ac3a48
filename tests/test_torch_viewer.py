"""The port's headless viewer against the reference's on one state: a small
RGB-D run of the reference, carried across with `utils/convert.py`, drawn by
both packages. Frame overlays must be equal byte for byte."""

import numpy as np
import pytest
import torch

from _torch_port import jnp_dict
from orb_slam2_e_tpu.models import viewer as ref_viewer
from orb_slam2_e_tpu_torch.models import viewer
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert, imageio

CAM = dict(fx=260, fy=260, cx=160, cy=120, bf=26.0, width=320, height=240)


@pytest.fixture(scope="module")
def small_run():
    """tests/test_viewer_examples.py::small_run, and its last frame and map
    as the port's tensors."""
    from orb_slam2_e_tpu.ops.camera import Camera as JCamera
    from orb_slam2_e_tpu.models.system import (SlamSystem, SystemConfig,
                                               Sensor)
    from orb_slam2_e_tpu.utils.synthetic import (SyntheticScene,
                                                 orbit_trajectory)
    scene = SyntheticScene(n_points=400, seed=3, width=320, height=240,
                           fx=260, fy=260, cx=160, cy=120)
    poses, _ = orbit_trajectory(n_frames=8, radius=0.8, forward=0.05)
    cfg = SystemConfig(max_keyframes=16, max_points=4096, n_features=300,
                       n_levels=3, max_frames_between_kf=3)
    sys = SlamSystem(JCamera.create(**CAM), cfg, Sensor.RGBD)
    imgs = []
    for k, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        sys.track_rgbd(img, scene.depth_map(R, t), k / 30.0)
        imgs.append(img)
    frame = convert.frame_from_numpy(jnp_dict(sys.last_frame), "cpu")
    state = convert.map_state_from_numpy(jnp_dict(sys.map), "cpu")
    return sys, imgs, frame, state


def test_draw_frame(small_run, tmp_path):
    sys, imgs, frame, _ = small_run
    want = ref_viewer.draw_frame(imgs[-1], sys.last_frame,
                                 state_text=sys.state.name)
    got = viewer.draw_frame(imgs[-1], frame, state_text=sys.state.name)
    assert got.shape == (240, 320, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != np.stack([np.clip(imgs[-1], 0, 255).astype(np.uint8)] * 3,
                            -1)).any()           # something was drawn
    # an image tensor draws the same
    np.testing.assert_array_equal(
        viewer.draw_frame(torch.as_tensor(imgs[-1]), frame,
                          state_text=sys.state.name), want)
    # save_png: the package's writer, read back by both decoders (RGB to
    # grey) and, in colour, by OpenCV
    import cv2
    viewer.save_png(tmp_path / "frame.png", got)
    assert (tmp_path / "frame.png").stat().st_size > 1000
    back = cv2.imread(str(tmp_path / "frame.png"))[..., ::-1]
    np.testing.assert_array_equal(back, got)
    np.testing.assert_array_equal(
        imageio.read_gray8(tmp_path / "frame.png", "numpy"),
        imageio.read_gray8(tmp_path / "frame.png", "libpng"))


def test_draw_map(small_run, tmp_path):
    sys, _, _, state = small_run
    viewer.draw_map(state, tmp_path / "map.png")
    assert (tmp_path / "map.png").stat().st_size > 5000
    ref_viewer.draw_map(sys.map, tmp_path / "ref.png")
    got = imageio.read_gray8(tmp_path / "map.png")
    want = imageio.read_gray8(tmp_path / "ref.png")
    assert got.shape == want.shape
    # the same scatter and track: the renders differ by float rounding of
    # the keyframe centres at most
    assert (got != want).mean() < 0.01
    buf = viewer.draw_map(state)
    assert buf.ndim == 3 and buf.shape[2] == 3 and buf.dtype == np.uint8


@pytest.mark.parametrize("with_forces", [True, False])
def test_draw_frame_with_fem_mesh(small_run, with_forces):
    from orb_slam2_e_tpu.ops import fem as jfem
    import jax.numpy as jnp
    sys, imgs, frame, _ = small_run
    pid = np.asarray(sys.last_frame.point_ids)
    ok = pid >= 0
    pts = np.asarray(sys.map.lm_xyz)[pid[ok]]
    uv = np.asarray(sys.last_frame.uvr)[ok][:, :2]
    jmesh = jfem.build_mesh(pts, uv, el_type=1, max_nodes=2048,
                            max_elems=2048)
    assert jmesh is not None
    ke = jfem.element_stiffness_batch(jmesh)
    jforces = jfem.nodal_forces(jmesh, ke, jfem.node_positions(
        jmesh, jnp.asarray(pts)))
    mesh = convert.fem_mesh_from_numpy(
        {k: (v if k in ("el_type", "h") else np.asarray(v))
         for k, v in jmesh._asdict().items()}, "cpu")
    forces = torch.from_numpy(np.asarray(jforces).copy())
    cam = Camera.create(**CAM)
    f_ref, f_port = (jforces, forces) if with_forces else (None, None)
    want = ref_viewer.draw_frame(imgs[-1], sys.last_frame, "FEA",
                                 mesh=jmesh, forces=f_ref, cam=sys.cam)
    got = viewer.draw_frame(imgs[-1], frame, "FEA", mesh=mesh,
                            forces=f_port, cam=cam)
    assert got.shape == (240, 320, 3)
    np.testing.assert_array_equal(got, want)
    plain = viewer.draw_frame(imgs[-1], frame, "FEA")
    assert (got != plain).any()                  # the wireframe is there


def test_mesh_overlay_distorts(small_run):
    """With distortion coefficients the overlay goes through
    `camera.project(distort=True)`: the wireframe moves."""
    from orb_slam2_e_tpu_torch.ops import fem
    sys, imgs, frame, state = small_run
    pid = frame.point_ids.numpy()
    ok = pid >= 0
    mesh = fem.build_mesh(state.lm_xyz.numpy()[pid[ok]],
                          frame.uvr.numpy()[ok][:, :2], el_type=1,
                          max_nodes=2048, max_elems=2048, device="cpu")
    straight = viewer.draw_frame(imgs[-1], frame, mesh=mesh,
                                 cam=Camera.create(**CAM))
    bent = viewer.draw_frame(imgs[-1], frame, mesh=mesh,
                             cam=Camera.create(**CAM, k1=-0.3))
    assert (straight != bent).any()
