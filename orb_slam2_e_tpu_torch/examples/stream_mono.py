"""Streaming monocular node (twin of examples/stream_mono.py): the
equivalent of the reference's ROS node `MonoE` (reference
Examples/ROS/ORB_SLAM2_E/src/ros_mono.cc:46-95: subscribe to an image topic,
TrackMonocular per message, save the keyframe trajectory and the binary map
on shutdown).

Without ROS the stream is a line protocol on stdin, one image path per line
(pipe from a camera process, a rosbag extractor, or an `ls`-style replay):

    find seq/rgb -name '*.png' | sort | \\
        python3 -m orb_slam2_e_tpu_torch.examples.stream_mono settings.yaml \\
        --out-traj KeyFrameTrajectory.txt --out-map map.npz

An optional `<timestamp> <path>` form carries real capture times. If rospy
is importable (a real ROS environment), `--ros-topic` subscribes to a
sensor_msgs/Image topic instead, like the reference node.
"""

import sys
import time

from ..utils.datasets import read_gray
from ._common import Sensor, make_parser, open_system


def iter_stdin_stream():
    """Yield (timestamp, path) from the stdin line protocol."""
    t_fallback = 0.0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) >= 2:
            yield float(parts[0]), parts[1]
        else:
            yield t_fallback, parts[0]
            t_fallback += 1.0 / 30.0


def run_ros(sysm, topic):  # pragma: no cover - needs a ROS environment
    """Subscribe like the reference MonoE node (ros_mono.cc:46-70)."""
    import rospy
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image
    import cv2
    bridge = CvBridge()

    def cb(msg):
        im = bridge.imgmsg_to_cv2(msg)
        if im.ndim == 3:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
        sysm.track_monocular(im, msg.header.stamp.to_sec())

    rospy.init_node("MonoE", anonymous=True)
    rospy.Subscriber(topic, Image, cb, queue_size=1)
    rospy.spin()


def main(argv=None):
    """Run the example on `argv` (default: the command line); returns the
    system it drove."""
    ap = make_parser(__doc__)
    ap.add_argument("--ros-topic", default=None,
                    help="subscribe to this ROS image topic (needs rospy); "
                         "default: read image paths from stdin")
    ap.add_argument("--out-traj", default="KeyFrameTrajectory.txt")
    ap.add_argument("--out-map", default=None,
                    help="save the binary map on shutdown (reference "
                         "ros_mono.cc:73 SaveMap)")
    ap.add_argument("--localization", action="store_true",
                    help="localization-only mode (no mapping)")
    args = ap.parse_args(argv)

    _, sysm = open_system(args, Sensor.MONOCULAR)
    if args.localization:
        sysm.activate_localization_mode()

    if args.ros_topic:
        run_ros(sysm, args.ros_topic)
    else:
        n, t0 = 0, time.perf_counter()
        for ts, path in iter_stdin_stream():
            sysm.track_monocular(read_gray(path), ts)
            n += 1
        if n:
            dt = time.perf_counter() - t0
            print(f"tracked {n} frames, {n / dt:.1f} fps", file=sys.stderr)

    sysm.shutdown()
    sysm.save_keyframe_trajectory_tum(args.out_traj)
    if args.out_map:
        sysm.save_map(args.out_map)
    print(f"trajectory saved to {args.out_traj}", file=sys.stderr)
    return sysm


if __name__ == "__main__":
    main()
