"""Stereo EuRoC example (twin of examples/stereo_euroc.py; reference
Examples/Stereo/stereo_euroc.cc): raw stereo pairs are rectified with the
LEFT.* / RIGHT.* calibration of the settings YAML before tracking.

Usage: python3 -m orb_slam2_e_tpu_torch.examples.stereo_euroc <settings.yaml>
           <sequence_dir> [timestamps.txt] [--device cuda] [--seed 0]
"""

from ..utils.config import stereo_rectifier_from_settings
from ..utils.datasets import load_euroc, read_gray
from ._common import Sensor, make_parser, open_system, print_times, timed


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("ts_file", nargs="?", default=None)
    args = ap.parse_args(argv)

    rect = stereo_rectifier_from_settings(args.settings, device=args.device)
    if rect is None:
        print("WARNING: no LEFT.*/RIGHT.* rectification blocks in settings; "
              "assuming pre-rectified input")
    _, sysm = open_system(args, Sensor.STEREO)

    ts, lefts = load_euroc(args.seq_dir, args.ts_file)
    # swap only the camera path component, never other 'cam0' substrings
    rights = [p.replace("/cam0/data/", "/cam1/data/") for p in lefts]
    print(f"Images in the sequence: {len(lefts)}")

    track_times = []
    for t, lp, rp in zip(ts, lefts, rights):
        im_l, im_r = read_gray(lp), read_gray(rp)
        if rect is not None:
            im_l, im_r = rect(im_l, im_r)
        timed(track_times, sysm.track_stereo, im_l, im_r, t)
    sysm.shutdown()
    print_times(track_times)
    sysm.save_trajectory_tum("CameraTrajectory.txt")
    return sysm


if __name__ == "__main__":
    main()
