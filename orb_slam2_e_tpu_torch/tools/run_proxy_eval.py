"""End-to-end evaluation on the real-texture proxy sequences (twin of
tools/run_proxy_eval.py, extended to the KITTI and EuRoC proxies).

Generates the proxy sequences where they are absent (or were made with
other arguments) and runs the port's example programs on them through
`main(argv)`, each in a working directory of its own under the output
directory, then computes ATE RMSE against the ground truth with the TUM
protocol (Sim3 alignment for monocular, SE3 for RGB-D and stereo), each
estimated timestamp associated with the first ground-truth timestamp not
before it. The sequences and what runs on them:

- `xyz`, `desk` (`make_proxy_dataset`, 640x480, seed 0): `mono_tum` and
  `rgbd_tum` (sensors `mono`, `rgbd`);
- `kitti` (`make_proxy_kitti`, 640x256 stereo at a 0.12 m baseline, seed
  1): `stereo_kitti` and `mono_kitti` (sensors `stereo`, `mono`);
- `euroc` (`make_proxy_euroc`, raw distorted 512x384 stereo, seed 2):
  `stereo_euroc` with the rectifier of the LEFT./RIGHT. blocks,
  `mono_euroc` on the raw frames with the distorted camera of
  `settings_mono.yaml`, and `stream_mono` on the same frames and settings
  through its `<timestamp> <path>` line protocol on stdin (sensors
  `stereo`, `mono`, `stream`).

A sensor that a sequence has no example for is skipped with a line. The
KITTI and EuRoC entries also keep the frame and keyframe trajectories of
the system the example returns (the KITTI stereo example writes its
trajectory in KITTI's 3x4 form, which carries no timestamps), the median
ms of decoding a frame with `read_gray`, and with `--stage-ms` the median
ms of the system's stages, each timed between synchronizations of the
device (which takes the pipelined loop's overlap away: frames/s is then a
lower bound), and for `stereo_euroc` the rectifier's ms per pair.

Unlike the reference's runner it holds the results to the JAX package's
end-to-end gates: RGB-D and stereo track at least n - 1 of n frames with
SE3 ATE under 0.08 m; monocular initializes by frame 12 with Sim3 ATE
under 0.10 m (`stream_mono`'s keyframe trajectory too). On the KITTI and
EuRoC proxies a gate applies where the reference meets it on the same
files (`--ref`, the reference's results as
`tests/test_torch_kitti_euroc.py ref` writes them, read for the sequences
generated with the same arguments). Where the reference misses it, the
port is held to the reference's own result: no fewer tracked frames less
one, and ATE within 2x of the reference's; the entry's `gate` says which
rule held it and why. The results are written first (`PROXY_RESULTS.json`,
merged with the entries of sequences not run this time, and the
trajectories), then a gate that failed ends the run with an error.

The sequences are no substitute for TUM's, KITTI's or EuRoC's: real
imagery, exact geometry, no sensor noise. The numbers are not comparable
with published results on those datasets.

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.run_proxy_eval [--frames 400]
        [--seqs xyz,desk,kitti,euroc] [--sensors mono,rgbd,stereo,stream]
        [--device cuda] [--seed 0] [--stage-ms] [--data-dir data]
        [--out-dir eval/torch]
        [--ref eval/torch/reference_cpu/PROXY_RESULTS.json]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import imageio
from ..utils.datasets import load_euroc, load_kitti, read_gray
from ..utils.trajectory import ate_rmse, load_tum
from . import make_proxy_dataset, make_proxy_euroc, make_proxy_kitti
from .proxy_render import TEXTURES

ROOT = Path(__file__).resolve().parents[2]
RGBD_ATE_MAX = 0.08        # metres, SE3-aligned (RGB-D and stereo)
MONO_ATE_MAX = 0.10        # Sim3-aligned
MONO_INIT_BY = 12          # frame index
REF_ATE_FACTOR = 2.0       # a gate the reference misses: ATE within 2x
# the KITTI and EuRoC proxies: generator (its default seed) and frame rate,
# and the example each sensor runs
STEREO_SEQS = {"kitti": (make_proxy_kitti, 1, make_proxy_kitti.FPS),
               "euroc": (make_proxy_euroc, 2, make_proxy_euroc.FPS)}
EXAMPLES = {"kitti": {"stereo": "stereo_kitti", "mono": "mono_kitti"},
            "euroc": {"stereo": "stereo_euroc", "mono": "mono_euroc",
                      "stream": "stream_mono"}}
# the system's methods timed by --stage-ms; time spent in a nested timed
# call is taken off the stage around it (`_super` holds the tracking, the
# keyframe decision and the queued insertion `_super_insert`)
STAGES = {"_make_frame_inputs": "extract", "_super": "track",
          "_track_step": "track", "_super_insert": "insert+map",
          "_insert_keyframe": "insert+map", "_initialize": "init",
          "_relocalize": "relocalize", "_drain_pending": "drain"}


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


def loop_name(sysm) -> str:
    """The frame loop a system's tracked frames ran."""
    return "pipelined" if sysm.pipelined else "synchronous"


def run_example(example, argv):
    """`example.main(argv)`; returns (seconds, frames, frame loop) and
    frees the system's memory."""
    t0 = time.perf_counter()
    sysm = example.main(argv)
    seconds = time.perf_counter() - t0
    frames, loop = sysm.frame_id + 1, loop_name(sysm)
    del sysm
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return seconds, frames, loop


def run_mono(d: Path, gt: Path, evald: Path, seq: str, args, common):
    from ..examples import mono_tum
    kf_out = evald / f"KeyFrameTrajectory_mono_{seq}.txt"
    fr_out = evald / f"FrameTrajectory_mono_{seq}.txt"
    with working_dir(evald):
        seconds, n, loop = run_example(mono_tum, [
            str(d / "settings.yaml"), str(d), str(kf_out), *common])
        Path("FrameTrajectory.txt").replace(fr_out)
    ate_kf, n_kf, _ = ate_vs_gt(kf_out, gt, with_scale=True)
    ate_fr, n_fr, t_first = ate_vs_gt(fr_out, gt, with_scale=True)
    init = (None if t_first is None
            else int(round(t_first * make_proxy_dataset.FPS)))
    res = dict(ate_rmse_frames_m=_round(ate_fr), frames_tracked=n_fr,
               ate_rmse_keyframes_m=_round(ate_kf), n_keyframes=n_kf,
               total_frames=args.frames, alignment="Sim3",
               initialized_at_frame=init, loop=loop)
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
        seconds, n, loop = run_example(rgbd_tum, [
            str(d / "settings.yaml"), str(d), str(d / "associations.txt"),
            *common])
        Path("CameraTrajectory.txt").replace(rd_out)
        Path("KeyFrameTrajectory.txt").replace(rdk_out)
    ate_rd, n_rd, _ = ate_vs_gt(rd_out, gt, with_scale=False)
    res = dict(ate_rmse_frames_m=_round(ate_rd), frames_tracked=n_rd,
               total_frames=args.frames, alignment="SE3 (no scale)",
               loop=loop)
    fails = []
    if n_rd < args.frames - 1:
        fails.append(f"rgbd_{seq}: {n_rd} of {args.frames} frames tracked")
    elif not ate_rd < RGBD_ATE_MAX:
        fails.append(f"rgbd_{seq}: SE3 ATE {ate_rd:.4f} m >= "
                     f"{RGBD_ATE_MAX}")
    print(f"rgbd_{seq}: ATE {res['ate_rmse_frames_m']} m over {n_rd} "
          f"frames, {n / seconds:.2f} frames/s")
    return res, seconds, n, fails


def example_args(seq: str, sensor: str, d: Path):
    """(argv, stdin text or None) of the example that `sensor` runs on the
    KITTI or EuRoC proxy at `d`; the reference's examples take the same
    arguments."""
    settings = d / "settings.yaml"
    if seq == "kitti":
        return ([settings, d] if sensor == "stereo"
                else [settings, d, "KeyFrameTrajectory.txt"]), None
    stamps = d / "timestamps.txt"
    if sensor == "stereo":
        return [settings, d, stamps], None
    mono = d / "settings_mono.yaml"
    if sensor == "mono":
        return [mono, d, stamps, "KeyFrameTrajectory.txt"], None
    ts, paths = load_euroc(d, stamps)
    return ([mono, "--out-traj", "KeyFrameTrajectory.txt"],
            "".join(f"{float(t)!r} {p}\n" for t, p in zip(ts, paths)))


@contextlib.contextmanager
def stdin_text(text):
    """`sys.stdin` reads `text` inside the block (nothing changes for
    None)."""
    if text is None:
        yield
        return
    saved, sys.stdin = sys.stdin, io.StringIO(text)
    try:
        yield
    finally:
        sys.stdin = saved


def collect_outputs(work: Path, evald: Path, key: str, sysm):
    """Move the files an example wrote in `work` to `evald` as
    `<stem>_<key><suffix>`, then write the frame and keyframe trajectories
    (TUM form) of the system it returned where the example wrote none:
    `FrameTrajectory_<key>.txt`, `KeyFrameTrajectory_<key>.txt`. Works for
    either package's system."""
    for f in sorted(work.iterdir()):
        if f.is_file():
            f.replace(evald / f"{f.stem}_{key}{f.suffix}")
    frames = evald / f"FrameTrajectory_{key}.txt"
    keyframes = evald / f"KeyFrameTrajectory_{key}.txt"
    if not frames.exists():
        sysm.save_trajectory_tum(str(frames))
    if not keyframes.exists():
        sysm.save_keyframe_trajectory_tum(str(keyframes))
    return frames, keyframes


def _ate(path, gt, with_scale):
    """`ate_vs_gt`, with no ATE under three rows (an alignment of fewer
    fits them exactly)."""
    ate, n, t_first = ate_vs_gt(path, gt, with_scale)
    return (ate if n >= 3 else None), n, t_first


def score_entry(seq: str, sensor: str, frames: Path, keyframes: Path,
                gt: Path, total: int) -> dict:
    """The numbers of one KITTI / EuRoC entry from its trajectories."""
    mono = sensor != "stereo"
    fps = STEREO_SEQS[seq][2]
    ate_fr, n_fr, t_first = _ate(frames, gt, mono)
    ate_kf, n_kf, _ = _ate(keyframes, gt, mono)
    res = dict(example=EXAMPLES[seq][sensor],
               ate_rmse_frames_m=_round(ate_fr), frames_tracked=n_fr,
               ate_rmse_keyframes_m=_round(ate_kf), n_keyframes=n_kf,
               total_frames=total,
               alignment="Sim3" if mono else "SE3 (no scale)")
    if mono:
        res["initialized_at_frame"] = (None if t_first is None
                                       else int(round(t_first * fps)))
    return res


def e2e_misses(sensor: str, res: dict) -> list:
    """How `res` misses the JAX package's end-to-end gate (empty: it
    meets it)."""
    ate = res["ate_rmse_frames_m"]
    if sensor == "stereo":
        if res["frames_tracked"] < res["total_frames"] - 1:
            return [f"{res['frames_tracked']} of {res['total_frames']} "
                    f"frames tracked"]
        if ate is None or not ate < RGBD_ATE_MAX:
            return [f"SE3 ATE {ate} m, not under {RGBD_ATE_MAX}"]
        return []
    init = res["initialized_at_frame"]
    if init is None or init > MONO_INIT_BY:
        return [f"initialized at frame {init}, not by {MONO_INIT_BY}"]
    misses = []
    if ate is None or not ate < MONO_ATE_MAX:
        misses.append(f"Sim3 ATE {ate} m, not under {MONO_ATE_MAX}")
    kf = res["ate_rmse_keyframes_m"]
    if sensor == "stream" and (kf is None or not kf < MONO_ATE_MAX):
        misses.append(f"keyframe Sim3 ATE {kf} m, not under "
                      f"{MONO_ATE_MAX}")
    return misses


def gate_entry(sensor: str, res: dict, ref) -> list:
    """Hold `res` to the end-to-end gate where the reference's result
    `ref` on the same files meets it (or where there is none), else to
    the reference's own result. Sets `res["gate"]` to the rule and why;
    returns the failures."""
    own = e2e_misses(sensor, res)
    if ref is None:
        res["gate"] = "the e2e gate (no reference result on these files)"
        return own
    res["reference"] = {k: ref.get(k) for k in (
        "ate_rmse_frames_m", "frames_tracked", "ate_rmse_keyframes_m",
        "n_keyframes", "initialized_at_frame") if k in ref}
    ref_misses = e2e_misses(sensor, ref)
    if not ref_misses:
        res["gate"] = "the e2e gate, which the reference meets on these files"
        return own
    res["gate"] = (f"the reference's own result, since the reference "
                   f"misses the e2e gate on these files "
                   f"({'; '.join(ref_misses)}): at least its tracked "
                   f"frames less one, ATE within {REF_ATE_FACTOR:g}x of its")
    fails = []
    if res["frames_tracked"] < ref["frames_tracked"] - 1:
        fails.append(f"{res['frames_tracked']} frames tracked, the "
                     f"reference {ref['frames_tracked']}")
    for k in ("ate_rmse_frames_m", "ate_rmse_keyframes_m"):
        want, got = ref[k], res[k]
        if want is not None and (got is None
                                 or got > REF_ATE_FACTOR * want):
            fails.append(f"{k} {got}, the reference {want}")
    return fails


def same_data(a: dict, b: dict) -> bool:
    """Two proxy.json records of the same frames (the device they were
    rendered on aside: the card renders the CPU's frames bit for bit)."""
    keys = ("generator", "frames", "seed", "textures")
    return all(a.get(k) == b.get(k) for k in keys)


def reference_entry(ref_path, key: str, data: dict):
    """The reference's result for `key` on the frames `data` describes,
    or None."""
    if not ref_path or not Path(ref_path).exists():
        return None
    ref = json.loads(Path(ref_path).read_text()).get(key)
    if ref is None or not same_data(ref.get("data", {}), data):
        return None
    return ref


def decode_ms(paths) -> float:
    """Median ms of `read_gray` (backend "auto") per file."""
    ms = []
    for path in paths:
        t0 = time.perf_counter()
        read_gray(path)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


class StageTimer:
    """Times the STAGES of each system an example opens, between
    synchronizations of its device; the rectifier's pairs too. Patches the
    example module's `open_system` (and `stereo_rectifier_from_settings`)
    inside its block."""

    def __init__(self, module, device):
        self.module, self.device = module, torch.device(device)
        self.ms = {}
        self.stack = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, key, fn, idle=None):
        def wrapper(*args, **kwargs):
            if idle is not None and idle():   # nothing to do: no sample
                return fn(*args, **kwargs)
            self.sync()
            self.stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                ms = (time.perf_counter() - t0) * 1e3
                inner = self.stack.pop()
                if self.stack:
                    self.stack[-1] += ms
                self.ms.setdefault(key, []).append(ms - inner)
        return wrapper

    def __enter__(self):
        m = self.module
        self.saved = {k: getattr(m, k) for k in (
            "open_system", "stereo_rectifier_from_settings") if hasattr(m, k)}
        opened = self.saved["open_system"]

        def open_system(*args, **kwargs):
            s, sysm = opened(*args, **kwargs)
            for attr, key in STAGES.items():
                idle = ((lambda: not sysm._pending)
                        if attr == "_drain_pending" else None)
                setattr(sysm, attr, self.timed(key, getattr(sysm, attr),
                                               idle))
            return s, sysm
        m.open_system = open_system
        if "stereo_rectifier_from_settings" in self.saved:
            make = self.saved["stereo_rectifier_from_settings"]

            def rectifier(*args, **kwargs):
                rect = make(*args, **kwargs)
                return (None if rect is None
                        else self.timed("rectify pair", rect))
            m.stereo_rectifier_from_settings = rectifier
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)

    def medians(self) -> dict:
        return {k: round(statistics.median(v), 3) for k, v in
                sorted(self.ms.items())}

    def counts(self) -> dict:
        return {k: len(v) for k, v in sorted(self.ms.items())}


def run_entry(seq: str, sensor: str, d: Path, evald: Path, args, common,
              ref_path):
    """One KITTI / EuRoC example through `main(argv)` in a working
    directory of its own; returns (result, seconds, frames, failures)."""
    key = f"{sensor}_{seq}"
    module = importlib.import_module(
        f"..examples.{EXAMPLES[seq][sensor]}", __package__)
    argv, stdin = example_args(seq, sensor, d)
    timer = StageTimer(module, args.device)
    with working_dir(evald) as work, stdin_text(stdin), (
            timer if args.stage_ms else contextlib.nullcontext()):
        t0 = time.perf_counter()
        sysm = module.main([*map(str, argv), *common])
        seconds = time.perf_counter() - t0
        n, loop = len(sysm.trajectory), loop_name(sysm)
        frames, keyframes = collect_outputs(work, evald, key, sysm)
        del sysm
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    data = json.loads((d / "proxy.json").read_text())
    res = score_entry(seq, sensor, frames, keyframes,
                      d / "groundtruth_tum.txt", args.frames)
    res["loop"] = loop
    res["seed"] = args.seed
    if args.stage_ms:
        res["stage_ms"] = timer.medians()
        res["stage_calls"] = timer.counts()
    fails = [f"{key}: {f}" for f in gate_entry(
        sensor, res, reference_entry(ref_path, key, data))]
    init = (f", initialized at frame {res['initialized_at_frame']}"
            if "initialized_at_frame" in res else "")
    print(f"{key}: {res['alignment'].split()[0]} ATE "
          f"{res['ate_rmse_frames_m']} m over {res['frames_tracked']} of "
          f"{args.frames} frames{init}, {res['n_keyframes']} keyframes, "
          f"{n / seconds:.2f} frames/s; gate: {res['gate']}")
    return res, seconds, n, fails


def ensure_stereo_sequence(seq: str, args) -> Path:
    """The KITTI or EuRoC proxy under the data directory, generated with
    its generator's default seed where absent."""
    module, seed, _ = STEREO_SEQS[seq]
    d = Path(args.data_dir).resolve() / f"proxy_{seq}"
    ensure_sequence(d, module, ["--frames", args.frames, "--device",
                                args.device],
                    {"frames": args.frames, "seed": seed,
                     "textures": list(TEXTURES)})
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--seqs", default="xyz,desk")
    ap.add_argument("--sensors", default="mono,rgbd")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renderer and the systems")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the examples' RANSAC draws")
    ap.add_argument("--stage-ms", action="store_true",
                    help="KITTI / EuRoC: time the stages (synchronized)")
    ap.add_argument("--data-dir", default=str(ROOT / "data"))
    ap.add_argument("--out-dir", default=str(ROOT / "eval" / "torch"))
    ap.add_argument("--ref", default=str(ROOT / "eval" / "torch" /
                                         "reference_cpu" /
                                         "PROXY_RESULTS.json"),
                    help="the reference's KITTI / EuRoC results")
    args = ap.parse_args(argv)

    evald = Path(args.out_dir).resolve()
    evald.mkdir(parents=True, exist_ok=True)
    out_json = evald / "PROXY_RESULTS.json"
    results = json.loads(out_json.read_text()) if out_json.exists() else {}
    card = device_line(args.device)
    common = ["--device", args.device, "--seed", str(args.seed)]
    runners = {"mono": run_mono, "rgbd": run_rgbd}
    fails = []

    def record(key, res, seconds, n):
        res.update(device=card, textures=list(TEXTURES),
                   frames=n, package="torch", seconds=round(seconds, 1),
                   frames_per_s=round(n / seconds, 3))
        results[key] = res
        out_json.write_text(json.dumps(results, indent=2) + "\n")

    for seq in args.seqs.split(","):
        if seq in STEREO_SEQS:
            d = ensure_stereo_sequence(seq, args)
            paths = (load_euroc(d)[1] if seq == "euroc"
                     else load_kitti(d)[1])
            decoder, why = imageio.auto_backend()
            ms = decode_ms(paths)
            print(f"proxy_{seq}: PNG decoder \"auto\": {decoder} "
                  f"({' '.join(why.split())[:200]}); read_gray {ms:.2f} ms "
                  f"per left frame (median of {len(paths)})")
            for sensor in args.sensors.split(","):
                if sensor not in EXAMPLES[seq]:
                    print(f"proxy_{seq}: no {sensor} example; skipped")
                    continue
                res, seconds, n, f = run_entry(seq, sensor, d, evald, args,
                                               common, args.ref)
                res.update(png_decoder=decoder,
                           decode_ms_per_frame=round(ms, 3))
                record(f"{sensor}_{seq}", res, seconds, n)
                fails += f
            continue
        d = Path(args.data_dir).resolve() / f"proxy_{seq}"
        ensure_sequence(d, make_proxy_dataset, [
            "--seq", seq, "--frames", args.frames, "--device", args.device],
            {"frames": args.frames, "seq": seq, "seed": 0,
             "textures": list(TEXTURES)})
        gt = d / "groundtruth.txt"
        for sensor in args.sensors.split(","):
            if sensor not in runners:
                print(f"proxy_{seq}: no {sensor} example; skipped")
                continue
            res, seconds, n, f = runners[sensor](d, gt, evald, seq, args,
                                                 common)
            record(f"{sensor}_{seq}", res, seconds, n)
            fails += f

    print(json.dumps(results, indent=2))
    if fails:
        raise SystemExit("gates failed: " + "; ".join(fails))


if __name__ == "__main__":
    main()
