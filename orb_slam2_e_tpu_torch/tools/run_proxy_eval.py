"""End-to-end evaluation on the real-texture proxy sequences (twin of
tools/run_proxy_eval.py).

Generates the TUM-format proxy sequences `proxy_xyz` and `proxy_desk` with
`make_proxy_dataset` where they are absent (or were made with other
arguments), runs the port's `examples.mono_tum` and `examples.rgbd_tum` on
them through `main(argv)`, each in a working directory of its own under
the output directory, and computes ATE RMSE against the ground truth with
the TUM protocol (Sim3 alignment for monocular, SE3 for RGB-D), each
estimated timestamp associated with the first ground-truth timestamp not
before it.

Unlike the reference's runner it holds the results to the JAX package's
end-to-end gates: RGB-D tracks at least n - 1 of n frames with SE3 ATE
under 0.08 m; monocular initializes by frame 12 with Sim3 ATE under
0.10 m. The results are written first (`PROXY_RESULTS.json`, merged with
the entries of sequences not run this time, and the trajectories), then a
gate that failed ends the run with an error.

The sequences are no substitute for TUM's: real imagery, exact geometry,
no sensor noise. The numbers are not comparable with published fr1_xyz /
fr1_desk results.

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.run_proxy_eval [--frames 400]
        [--seqs xyz,desk] [--sensors mono,rgbd] [--device cuda]
        [--data-dir data] [--out-dir eval/torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.trajectory import ate_rmse, load_tum
from . import make_proxy_dataset
from .proxy_render import TEXTURES

ROOT = Path(__file__).resolve().parents[2]
RGBD_ATE_MAX = 0.08        # metres, SE3-aligned
MONO_ATE_MAX = 0.10        # Sim3-aligned
MONO_INIT_BY = 12          # frame index


def device_line(device) -> str:
    """The card's `name, power limit` as nvidia-smi reports them, or the
    device's name when it is not a CUDA device."""
    if torch.device(device).type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ensure_sequence(path: Path, module, argv: list, want: dict):
    """Generate the sequence at `path` with `module.main(argv)` unless its
    proxy.json already records the arguments in `want`."""
    rec = path / "proxy.json"
    if rec.exists():
        have = json.loads(rec.read_text())
        if all(have.get(k) == v for k, v in want.items()):
            return
        print(f"{path}: made with other arguments ({have}); regenerating")
        shutil.rmtree(path)
    module.main([str(path), *map(str, argv)])


def ate_vs_gt(traj_path, gt_path, with_scale):
    """(ATE RMSE, rows, first timestamp) of a TUM trajectory against the
    ground truth; (None, 0, None) for a trajectory with no row."""
    if not any(ln.strip() and not ln.startswith("#")
               for ln in Path(traj_path).read_text().splitlines()):
        return None, 0, None
    ts_e, t_e, _ = load_tum(traj_path)
    ts_g, t_g, _ = load_tum(gt_path)
    gi = np.clip(np.searchsorted(ts_g, ts_e), 0, len(ts_g) - 1)
    return ate_rmse(t_e, t_g[gi], with_scale=with_scale), len(ts_e), ts_e[0]


def _round(ate):
    return None if ate is None else round(ate, 4)


@contextlib.contextmanager
def working_dir(parent: Path):
    """A fresh directory under `parent`, made the working directory (the
    examples write their trajectories where they run); removed after."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=parent, prefix="work_") as d:
        os.chdir(d)
        try:
            yield Path(d)
        finally:
            os.chdir(cwd)


def run_example(example, argv):
    """`example.main(argv)`; returns (seconds, frames) and frees the
    system's memory."""
    t0 = time.perf_counter()
    sysm = example.main(argv)
    seconds = time.perf_counter() - t0
    frames = sysm.frame_id + 1
    del sysm
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return seconds, frames


def run_mono(d: Path, gt: Path, evald: Path, seq: str, args, common):
    from ..examples import mono_tum
    kf_out = evald / f"KeyFrameTrajectory_mono_{seq}.txt"
    fr_out = evald / f"FrameTrajectory_mono_{seq}.txt"
    with working_dir(evald):
        seconds, n = run_example(mono_tum, [
            str(d / "settings.yaml"), str(d), str(kf_out), *common])
        Path("FrameTrajectory.txt").replace(fr_out)
    ate_kf, n_kf, _ = ate_vs_gt(kf_out, gt, with_scale=True)
    ate_fr, n_fr, t_first = ate_vs_gt(fr_out, gt, with_scale=True)
    init = (None if t_first is None
            else int(round(t_first * make_proxy_dataset.FPS)))
    res = dict(ate_rmse_frames_m=_round(ate_fr), frames_tracked=n_fr,
               ate_rmse_keyframes_m=_round(ate_kf), n_keyframes=n_kf,
               total_frames=args.frames, alignment="Sim3",
               initialized_at_frame=init)
    fails = []
    if init is None or init > MONO_INIT_BY:
        fails.append(f"mono_{seq}: initialized at frame {init}, not by "
                     f"{MONO_INIT_BY}")
    elif not ate_fr < MONO_ATE_MAX:
        fails.append(f"mono_{seq}: Sim3 ATE {ate_fr:.4f} m >= "
                     f"{MONO_ATE_MAX}")
    print(f"mono_{seq}: ATE {res['ate_rmse_frames_m']} m over {n_fr} "
          f"frames, initialized at frame {init}, {n / seconds:.2f} frames/s")
    return res, seconds, n, fails


def run_rgbd(d: Path, gt: Path, evald: Path, seq: str, args, common):
    from ..examples import rgbd_tum
    rd_out = evald / f"CameraTrajectory_rgbd_{seq}.txt"
    rdk_out = evald / f"KeyFrameTrajectory_rgbd_{seq}.txt"
    with working_dir(evald):
        seconds, n = run_example(rgbd_tum, [
            str(d / "settings.yaml"), str(d), str(d / "associations.txt"),
            *common])
        Path("CameraTrajectory.txt").replace(rd_out)
        Path("KeyFrameTrajectory.txt").replace(rdk_out)
    ate_rd, n_rd, _ = ate_vs_gt(rd_out, gt, with_scale=False)
    res = dict(ate_rmse_frames_m=_round(ate_rd), frames_tracked=n_rd,
               total_frames=args.frames, alignment="SE3 (no scale)")
    fails = []
    if n_rd < args.frames - 1:
        fails.append(f"rgbd_{seq}: {n_rd} of {args.frames} frames tracked")
    elif not ate_rd < RGBD_ATE_MAX:
        fails.append(f"rgbd_{seq}: SE3 ATE {ate_rd:.4f} m >= "
                     f"{RGBD_ATE_MAX}")
    print(f"rgbd_{seq}: ATE {res['ate_rmse_frames_m']} m over {n_rd} "
          f"frames, {n / seconds:.2f} frames/s")
    return res, seconds, n, fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--seqs", default="xyz,desk")
    ap.add_argument("--sensors", default="mono,rgbd")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renderer and the systems")
    ap.add_argument("--data-dir", default=str(ROOT / "data"))
    ap.add_argument("--out-dir", default=str(ROOT / "eval" / "torch"))
    args = ap.parse_args(argv)

    evald = Path(args.out_dir).resolve()
    evald.mkdir(parents=True, exist_ok=True)
    out_json = evald / "PROXY_RESULTS.json"
    results = json.loads(out_json.read_text()) if out_json.exists() else {}
    card = device_line(args.device)
    common = ["--device", args.device]
    runners = {"mono": run_mono, "rgbd": run_rgbd}
    fails = []

    for seq in args.seqs.split(","):
        d = Path(args.data_dir).resolve() / f"proxy_{seq}"
        ensure_sequence(d, make_proxy_dataset, [
            "--seq", seq, "--frames", args.frames, "--device", args.device],
            {"frames": args.frames, "seq": seq, "seed": 0,
             "textures": list(TEXTURES)})
        gt = d / "groundtruth.txt"
        for sensor in args.sensors.split(","):
            res, seconds, n, f = runners[sensor](d, gt, evald, seq, args,
                                                 common)
            res.update(device=card, textures=list(TEXTURES),
                       frames=n, package="torch", seconds=round(seconds, 1),
                       frames_per_s=round(n / seconds, 3))
            results[f"{sensor}_{seq}"] = res
            fails += f
            out_json.write_text(json.dumps(results, indent=2) + "\n")

    print(json.dumps(results, indent=2))
    if fails:
        raise SystemExit("gates failed: " + "; ".join(fails))


if __name__ == "__main__":
    main()
