"""Headless visualization: frame overlays and 3D map renders.

Port of `orb_slam2_e_tpu/models/viewer.py` (reference Viewer / FrameDrawer /
MapDrawer, src/Viewer.cc, src/FrameDrawer.cc, src/MapDrawer.cc) as
render-to-image functions: per-frame keypoint and match overlays with the
tracking-state banner, a 3D map scatter with the keyframe centres, and the
FEM mesh wireframe projected into the image with per-element force heat
colours (reference FrameDrawer.cc:196-224, MapDrawer.cc:83-130).

Host only: a `Frame`, `MapState` or `FemMesh` from any device is copied to
the host first. Renders return uint8 RGB arrays; `save_png` writes them.
OpenCV and matplotlib are imported inside the functions that draw.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import lie
from ..utils import imageio


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_u8(img):
    g = _np(img)
    if g.dtype != np.uint8:
        g = np.clip(g, 0, 255).astype(np.uint8)
    if g.ndim == 2:
        g = np.stack([g] * 3, -1)
    return g.copy()


def draw_frame(image, frame, state_text: str = "", mesh=None,
               forces=None, cam=None) -> np.ndarray:
    """Keypoint overlay (reference FrameDrawer::DrawFrame): tracked keypoints
    as green squares, untracked as blue dots; optionally the FEM mesh
    wireframe with force heat colours."""
    import cv2
    img = _to_u8(image)
    uv = _np(frame.uv_raw)
    valid = _np(frame.valid)
    pid = _np(frame.point_ids)
    for i in np.where(valid)[0]:
        x, y = int(uv[i, 0]), int(uv[i, 1])
        if pid[i] >= 0:
            cv2.rectangle(img, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
        else:
            cv2.circle(img, (x, y), 1, (255, 128, 0), -1)
    if mesh is not None and cam is not None:
        img = _draw_mesh_overlay(img, mesh, forces, frame, cam)
    n_tracked = int(((pid >= 0) & valid).sum())
    banner = f"{state_text}  KPs:{int(valid.sum())}  tracked:{n_tracked}"
    cv2.putText(img, banner, (8, img.shape[0] - 8),
                cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1)
    return img


def _draw_mesh_overlay(img, mesh, forces, frame, cam):
    """Project the layer-1 mesh triangles or quads into the raw image
    (`camera.project(distort=True)`, reference DistortMapPoint) and colour
    them by force magnitude."""
    import cv2
    n_surf = int(mesh.n_nodes_active) // 2
    R, t = lie.pose7_unpack(frame.pose7.detach().cpu())
    xc = lie.se3_apply(R, t, mesh.u0.detach().cpu()[:n_surf])
    # nodes at or behind the camera plane land far outside and are skipped
    xc = torch.cat([xc[:, :2], torch.clamp(xc[:, 2:], min=1e-6)], dim=1)
    uv = cam_ops.project(cam.to("cpu"), xc, distort=True)[0].numpy()
    u, v = uv[:, 0], uv[:, 1]
    if forces is not None:
        f = np.linalg.norm(_np(forces)[:n_surf], axis=1)
        fmax = max(f.max(), 1e-9)
    elems = _np(mesh.elements)
    valid_el = _np(mesh.elem_valid)
    n_corner = 3 if mesh.el_type == 1 else 4
    for e in np.where(valid_el)[0]:
        ring = [elems[e, i] for i in range(n_corner)]
        pts = np.asarray([[u[i], v[i]] for i in ring], np.int32)
        if (np.abs(pts) > 1e5).any():
            continue
        color = (0, 200, 255)
        if forces is not None:
            heat = float(np.mean([f[i] for i in ring]) / fmax)
            color = (int(255 * heat), 64, int(255 * (1 - heat)))
        cv2.polylines(img, [pts.reshape(-1, 1, 2)], True, color, 1)
    return img


def draw_map(state, path=None, figsize=(8, 6)):
    """3D map render (reference MapDrawer::DrawMapPoints / DrawKeyFrames):
    the landmark scatter and the keyframe centres joined in slot order."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection='3d')
    lm_ok = _np(state.lm_valid)
    xyz = _np(state.lm_xyz)[lm_ok]
    if len(xyz):
        ax.scatter(xyz[:, 0], xyz[:, 2], -xyz[:, 1], s=1, c='k', alpha=0.4)
    kf_ok = state.kf_valid.detach().cpu()
    R, t = lie.pose7_unpack(state.kf_pose7.detach().cpu()[kf_ok])
    _, twc = lie.se3_inverse(R, t)
    centers = twc.numpy()
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], -centers[:, 1], 'b.-',
                markersize=4, linewidth=0.8)
    ax.set_xlabel('x')
    ax.set_ylabel('z')
    ax.set_zlabel('-y')
    if path:
        fig.savefig(path, dpi=110, bbox_inches='tight')
        plt.close(fig)
        return None
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf


def save_png(path, img):
    """Write an (H, W, 3) uint8 RGB render (or an (H, W) grey image) with
    the package's own PNG writer."""
    imageio.write_png(path, np.ascontiguousarray(_np(img)))
