"""RGB-D TUM example (twin of examples/rgbd_tum.py; reference
Examples/RGB-D/rgbd_tum.cc).

Usage: python3 -m orb_slam2_e_tpu_torch.examples.rgbd_tum <settings.yaml>
           <sequence_dir> <assoc.txt> [--device cuda] [--seed 0]
"""

from ..utils.datasets import load_tum_associations, read_depth, read_gray
from ._common import Sensor, make_parser, open_system, print_times, timed


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("assoc")
    args = ap.parse_args(argv)

    _, sysm = open_system(args, Sensor.RGBD)
    ts, rgbs, depths = load_tum_associations(args.seq_dir, args.assoc)
    print(f"Images in the sequence: {len(rgbs)}")

    track_times = []
    for t, rp, dp in zip(ts, rgbs, depths):
        im = read_gray(rp)
        # RAW depth values: the system applies DepthMapFactor itself
        # (reference Tracking::GrabImageRGBD convertTo semantics)
        depth = read_depth(dp, 1.0)
        timed(track_times, sysm.track_rgbd, im, depth, t)
    sysm.shutdown()
    print_times(track_times, mean=False)
    sysm.save_trajectory_tum("CameraTrajectory.txt")
    sysm.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return sysm


if __name__ == "__main__":
    main()
