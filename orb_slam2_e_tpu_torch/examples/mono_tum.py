"""Monocular TUM example (twin of examples/mono_tum.py; reference
Examples/Monocular/mono_tum.cc).

Usage: python3 -m orb_slam2_e_tpu_torch.examples.mono_tum <settings.yaml>
           <sequence_dir> [out.txt] [--device cuda] [--seed 0]
"""

from ..utils.datasets import iter_gray, load_tum_rgb
from ._common import Sensor, make_parser, open_system, print_times, timed


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("out", nargs="?", default="KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    _, sysm = open_system(args, Sensor.MONOCULAR)
    ts, paths = load_tum_rgb(args.seq_dir)
    print(f"Images in the sequence: {len(paths)}")

    track_times = []
    for t, im in zip(ts, iter_gray(paths)):
        timed(track_times, sysm.track_monocular, im, t)
    sysm.shutdown()

    print_times(track_times)
    sysm.save_keyframe_trajectory_tum(args.out)
    sysm.save_trajectory_tum("FrameTrajectory.txt")
    print(f"trajectory saved to {args.out}")
    return sysm


if __name__ == "__main__":
    main()
