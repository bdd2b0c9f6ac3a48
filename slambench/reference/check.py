"""The comparison that decides `correct`: each number the plain reference
gives for what the window's timed path produced, beside its limit.

Each check takes the program's outputs (the candidate) and works the
reference out again from the benchmark's own inputs: the rendered images,
depth maps and raw pairs, the configuration's camera. With `control=True`
the candidate is the reference itself computed in bfloat16, the next
precision below the configuration's float32, put in the program's place;
that control has to come out as not correct.

Numbers, each "lower is better":
- `kp_mismatch_pct`: keypoints (octave, position, descriptor) that the
  program and the reference do not share, in % of their union.
- `depth_mismatch_pct`: the program's keypoints whose depth (RGB-D:
  sampled from the depth map; stereo: from the matcher against the
  reference's own right-image features) differs from the reference's by
  more than 1e-5 of it, or is missing on one side only, in %.
- `rect_gap`: the largest grey-level difference between the program's
  rectified images and the reference's.
- `pose_gap_mm`: over every tracked frame, the largest distance by which a
  landmark the frame binds lies apart between the program's pose and the
  float64 optimum of the frame's own inlier matches.
- `insert_gap_mm`: over every keyframe inserted in the window, the largest
  distance between a landmark the insertion created and the reference's
  back-projection of its keypoint at its depth from the keyframe's pose.
- `ba_shortfall` (`reference/ba.py`): over every local BA of the window,
  the share of the plain float64 local BA's cost decrease that the map the
  mapping pass left did not reach.
- `inlier_gap`: over every lane-step, the largest difference between a
  lane's inlier count and the number of its bound features within the
  chi-square threshold at the reference's pose.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry, orb, stereo

DEPTH_RTOL = 1e-5


def _kp_set(uv, octave, desc, valid):
    uv = uv.cpu().numpy()
    octave = octave.cpu().numpy()
    desc = desc.cpu().numpy()
    valid = valid.cpu().numpy()
    return {(int(o), float(u), float(v), d.tobytes())
            for (u, v), o, d, ok in zip(uv, octave, desc, valid) if ok}


def kp_mismatch_pct(pairs) -> float:
    """pairs: [(candidate (uv, octave, desc, valid), reference (...))]."""
    diff = total = 0
    for cand, ref in pairs:
        a, b = _kp_set(*cand), _kp_set(*ref)
        diff += len(a ^ b)
        total += len(a | b)
    return 100.0 * diff / max(total, 1)


def depth_mismatch_pct(pairs) -> float:
    """pairs: [(candidate depth (F,), reference depth (F,), valid (F,))]."""
    bad = total = 0
    for cand, ref, valid in pairs:
        cand, ref = cand.double(), ref.double()
        has_c, has_r = cand > 0, ref > 0
        off = (has_c != has_r) | (has_c & has_r & (
            torch.abs(cand - ref) > DEPTH_RTOL * torch.abs(ref)))
        bad += int((off & valid).sum())
        total += int(valid.sum())
    return 100.0 * bad / max(total, 1)


class Reference:
    """The reference's front end for one configuration."""

    def __init__(self, config: dict, device):
        s = config["settings"]
        self.config = config
        self.device = torch.device(device)
        self.scale = float(s["ORBextractor.scaleFactor"])
        self.levels = int(s["ORBextractor.nLevels"])
        self.n_features = int(s["ORBextractor.nFeatures"])
        self.ini = float(s["ORBextractor.iniThFAST"])
        self.min = float(s["ORBextractor.minThFAST"])
        self.cam = (float(s["Camera.fx"]), float(s["Camera.fy"]),
                    float(s["Camera.cx"]), float(s["Camera.cy"]),
                    float(s["Camera.bf"]))
        self.depth_factor = (1.0 / float(s["DepthMapFactor"])
                             if "DepthMapFactor" in s else None)
        self._maps = None

    def extractor(self, dtype=torch.float32, n_features=None, ini=None,
                  mn=None):
        return orb.Extractor(n_features or self.n_features, self.scale,
                             self.levels, self.ini if ini is None else ini,
                             self.min if mn is None else mn, dtype)

    def extract(self, image, dtype=torch.float32):
        return self.extractor(dtype)(torch.as_tensor(image,
                                                     device=self.device))

    def rectify(self, raw_l, raw_r, dtype=torch.float32):
        if self._maps is None:
            s = self.config["settings"]

            def m(k, shape):
                return np.asarray(s[k], np.float64).reshape(shape)
            w, h = s["LEFT.width"], s["LEFT.height"]
            self._maps = [torch.as_tensor(stereo.rectify_map(
                m(f"{side}.K", (3, 3)), m(f"{side}.D", (-1,)),
                m(f"{side}.R", (3, 3)), m(f"{side}.P", (3, 4)), w, h),
                device=self.device) for side in ("LEFT", "RIGHT")]
        return tuple(stereo.remap(torch.as_tensor(im, device=self.device),
                                  mp, dtype)
                     for im, mp in zip((raw_l, raw_r), self._maps))

    def stereo_depth(self, left_feats, img_l, img_r, dtype=torch.float32):
        """Depth of the given left features: the right image's features by
        the reference's extractor (the left capacity, FAST 20 / 7, as
        ORB-SLAM2's stereo front end builds it), then the matcher."""
        cap = int(left_feats[0].shape[0])
        right = self.extractor(dtype, n_features=cap, ini=20.0, mn=7.0)(
            img_r)
        return stereo.stereo_depth(left_feats, right, img_l, img_r,
                                   self.cam[4], self.scale, dtype=dtype)


def pose_numbers(ref: Reference, tracked: list, control: bool,
                 lanes: bool = False) -> dict:
    """`pose_gap_mm` (and with `lanes` the `inlier_gap`) over the tracked
    frames [dict(pose7, X, uvr, octave, bound, n_in)], solved in blocks."""
    gap, inl = 0.0, 0
    for i in range(0, len(tracked), 64):
        block = tracked[i:i + 64]

        def st(k, dt=None):
            t = torch.stack([torch.as_tensor(b[k]) for b in block]).to(
                ref.device)
            return t if dt is None else t.to(dt)
        pose7, X, uvr = st("pose7", torch.float64), st("X"), st("uvr")
        bound = st("bound").bool()
        inv_s2 = 1.0 / ref.scale ** (2.0 * st("octave", torch.float64))
        R0, t0 = geometry.solve_poses(ref.cam, pose7, X, uvr, inv_s2, bound)
        if control:
            R1, t1 = geometry.solve_poses(ref.cam, pose7, X, uvr, inv_s2,
                                          bound, dtype=torch.bfloat16)
            n1 = geometry.inlier_count(ref.cam, R1, t1, X, uvr, inv_s2,
                                       bound)
        else:
            R1, t1 = geometry.unpack(pose7)
            n1 = st("n_in", torch.int64)
        gap = max(gap, float(geometry.pose_gap_mm(R1, t1, R0, t0, X,
                                                  bound).max()))
        if lanes:
            n0 = geometry.inlier_count(ref.cam, R0, t0, X, uvr, inv_s2,
                                       bound)
            inl = max(inl, int((n1 - n0).abs().max()))
    out = {"pose_gap_mm": gap}
    if lanes:
        out["inlier_gap"] = float(inl)
    return out


def insertion_gap_mm(ref: Reference, inserts: list, control: bool) -> float:
    """`insert_gap_mm` over the keyframe insertions [dict(pose7, uvr, depth,
    new (F,) bool, xyz (F, 3) the program's new landmarks)]: each new
    landmark against the reference's back-projection of its keypoint at
    its depth from the keyframe's pose, in float64 (the control: in
    bfloat16)."""
    fx, fy, cx, cy, _ = ref.cam
    gap = 0.0
    for ins in inserts:
        new = ins["new"].to(ref.device)
        if not bool(new.any()):
            continue

        def world(dtype):
            R, t = geometry.unpack(ins["pose7"].to(ref.device), dtype)
            uvr = ins["uvr"].to(ref.device).to(dtype)[new]
            z = ins["depth"].to(ref.device).to(dtype)[new]
            xc = torch.stack([(uvr[:, 0] - cx) / fx * z,
                              (uvr[:, 1] - cy) / fy * z, z], -1)
            return ((xc - t) @ R).to(torch.float64)
        xyz = world(torch.float64)
        cand = (world(torch.bfloat16) if control else
                ins["xyz"].to(ref.device)[new].to(torch.float64))
        gap = max(gap, float(torch.linalg.norm(cand - xyz, dim=-1).max())
                  * 1e3)
    return gap


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct where every number the
    cell's limits name is present, finite and within its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not np.isfinite(v) or v > limit:
            ok = False
    return ok, checks
