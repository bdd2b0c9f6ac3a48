"""Deformable monocular example (twin of examples/mono_deformable.py): the
reference's primary workflow (`rosrun ORB_SLAM2_E MonoE voc settings` with a
rosbag, reference README.md:89-99 and
Examples/ROS/ORB_SLAM2_E/src/ros_mono.cc), here over an image directory.

Builds or loads a map, tracks with the deformable relocalization mode, and
reports the relocalization precision / recall KPI (reference
Tracking.cc:488-525). With `RelocParam.bTestAllFrames: 1` in the YAML every
frame is forced through relocalization (the KPI evaluation protocol).

Usage: python3 -m orb_slam2_e_tpu_torch.examples.mono_deformable
           <settings.yaml> <sequence_dir> [--load-map map.npz]
           [--save-map map.npz] [--stats StatsReloc.txt] [--device cuda]
           [--seed 0]
"""

from pathlib import Path

from ..utils.datasets import iter_gray, load_tum_rgb
from ._common import Sensor, make_parser, open_system, print_times, timed


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--stats", default=None)
    args = ap.parse_args(argv)

    # --stats takes the place of the settings' Output.StatsReloc
    over = {"stats_reloc_path": args.stats} if args.stats else {}
    s, sysm = open_system(args, Sensor.MONOCULAR, deformable=True, **over)
    if args.load_map:
        sysm.load_map(args.load_map)
        sysm.activate_localization_mode()

    seq = Path(args.seq_dir)
    if (seq / "rgb.txt").exists():
        ts, paths = load_tum_rgb(seq)
    else:
        paths = sorted(seq.glob("*.png")) or sorted(seq.glob("*.jpg"))
        fps = s.fps or 30.0
        ts = [i / fps for i in range(len(paths))]
    print(f"Images in the sequence: {len(paths)}")

    times = []
    for t, im in zip(ts, iter_gray(paths)):
        timed(times, sysm.track_monocular, im, t)
    if args.save_map:
        sysm.save_map(args.save_map)
    sysm.shutdown()

    print_times(times, mean=False)
    k = sysm.kpi
    print(f"reloc KPI: TP={k.tp} FP={k.fp} FN={k.fn} "
          f"precision={k.precision:.3f} recall={k.recall:.3f}")
    sysm.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return sysm


if __name__ == "__main__":
    main()
