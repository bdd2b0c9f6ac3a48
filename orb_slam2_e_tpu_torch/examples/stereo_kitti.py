"""Stereo KITTI example (twin of examples/stereo_kitti.py; reference
Examples/Stereo/stereo_kitti.cc).

Usage: python3 -m orb_slam2_e_tpu_torch.examples.stereo_kitti <settings.yaml>
           <sequence_dir> [--device cuda] [--seed 0]
"""

from ..utils.datasets import load_kitti, read_gray
from ._common import Sensor, make_parser, open_system, print_times, timed


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("seq_dir")
    args = ap.parse_args(argv)

    _, sysm = open_system(args, Sensor.STEREO)
    ts, lefts, rights = load_kitti(args.seq_dir, stereo=True)
    print(f"Images in the sequence: {len(lefts)}")

    track_times = []
    for t, lp, rp in zip(ts, lefts, rights):
        # as the reference's example, decoding is inside the timed call
        timed(track_times, lambda: sysm.track_stereo(
            read_gray(lp), read_gray(rp), t))
    sysm.shutdown()
    print_times(track_times, mean=False)
    sysm.save_trajectory_kitti("CameraTrajectory.txt")
    return sysm


if __name__ == "__main__":
    main()
