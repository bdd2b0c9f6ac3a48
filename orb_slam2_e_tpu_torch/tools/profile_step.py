"""Per-stage timing of the tracking hot path, and a profile of steady frames
(twin of tools/profile_step.py).

    python3 -m orb_slam2_e_tpu_torch.tools.profile_step [--sensor mono|rgbd]
        [--device cuda] [--small] [--pipeline]

Run it alone on the card. It builds a map from 20 frames of the benchmark
orbit (640x480, 8 levels, 1000 features, `bench.py`'s capacities), then
prints, as the reference's tool, the median ms of: extraction and its parts
at level 0, the three tracking stages and the fused step, keyframe insertion
with a mapping pass, and the six mapping sub-stages. Every timed call runs
between `torch.cuda.synchronize()` calls on a CUDA device and the first call
of each is left out.

Then what the layers table of PERF.md asks for and the reference's tool does
not have: ten more frames go through the system under `torch.profiler`, and
per frame it prints the kernel launches, the copies, the synchronizing CUDA
calls (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`), the device-busy time (the union of the device
intervals, so overlapping kernels count once) and its share of the frame
time, and the ten host functions with most self time. The profiler slows
the host several times over (about 6 s a frame where 0.7 s is the rate), so
the share is taken against the wall time of the frames just before, run
without it; reading the trace takes a few minutes more. On the CPU there
is no device activity: the counts print as 0 and the tool says so.

The system runs the synchronous frame loop (`pipeline=False`), or with
`--pipeline` the pipelined one that `SystemConfig()` and the examples run:
the map and the profiled frames then go through its super-step, and its
host reads the frames' flags every other frame.

The first line is the card's name and power limit as `nvidia-smi` gives
them.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from ..models import local_mapping as LMM
from ..models import tracking as T
from ..models.frame import frame_from_features
from ..models.system import Sensor, SlamSystem, SystemConfig, TrackState
from ..ops import kernels
from ..ops import orb as orb_mod
from ..ops.camera import Camera
from ..utils.synthetic import SyntheticScene, orbit_trajectory

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# the benchmark's size (bench.py's monocular capacities), and a small one
FULL = dict(width=640, height=480, features=1000, levels=8, frames=20,
            max_keyframes=64, max_points=16384, reps=10, profiled_frames=10)
SMALL = dict(width=320, height=240, features=300, levels=3, frames=8,
             max_keyframes=16, max_points=4096, reps=1, profiled_frames=2)


def card_line() -> str:
    """`name, power limit` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def med_ms(fn, device: torch.device, n: int = 10) -> float:
    """Median host ms of `fn`, the device drained before and after each
    call; the first (warm-up) call is not timed."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_frames(step, n_frames: int, device: torch.device,
                   host_top: int = 10) -> dict:
    """Run `step(i)` for i < n_frames under torch.profiler. Returns the
    per-frame counts and the busy share, read from the profiler's raw
    events, and the `host_top` host functions with most self time (0: none;
    they need the profiler's full event tree, whose building takes about
    40 s for one frame of 40,000 launches)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for i in range(n_frames):
            step(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_n = copies_n = syncs_n = 0
    dev_intervals = []
    # the events the profiler's own tree is built from, with its filter
    for ev in prof.profiler.kineto_results.events():
        if getattr(ev, "is_hidden_event", lambda: False)():
            continue
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if ev.name() in SYNC_CALLS:
                syncs_n += 1
            continue
        dev_intervals.append((ev.start_ns() / 1e3, ev.end_ns() / 1e3))
        if ev.name().startswith(("Memcpy", "Memset")):
            copies_n += 1
        else:
            kernels_n += 1
    host = []
    if host_top:
        host = sorted(((k.self_cpu_time_total / 1e3, k.count, k.key)
                       for k in prof.key_averages()
                       if k.device_type == torch.autograd.DeviceType.CPU),
                      reverse=True)[:host_top]
    return {
        "wall_ms": wall_ms / n_frames,
        "launches": kernels_n / n_frames,
        "copies": copies_n / n_frames,
        "syncs": syncs_n / n_frames,
        "busy_ms": _union_us(dev_intervals) / 1e3 / n_frames,
        "device_events": len(dev_intervals),
        "host": [(ms / n_frames, cnt / n_frames, name)
                 for ms, cnt, name in host],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sensor", choices=["mono", "rgbd"], default="mono")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="320x240, 3 levels, 300 features, 8 frames, one "
                         "timed call per stage, 2 profiled frames: a quick "
                         "run of every line, for the CPU")
    ap.add_argument("--pipeline", action="store_true",
                    help="the pipelined frame loop (SystemConfig()'s "
                         "default) instead of the synchronous one")
    args = ap.parse_args(argv)
    size = SMALL if args.small else FULL
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    print(card_line() if on_card else f"device: {dev} (no card: host times)")

    W, H = size["width"], size["height"]
    n_frames = size["frames"]
    fx = 500.0 * W / 640
    scene = SyntheticScene(n_points=600, seed=1, width=W, height=H,
                           fx=fx, fy=fx, cx=W / 2, cy=H / 2)
    n_prof = size["profiled_frames"]
    n_all = n_frames + n_prof
    # the benchmark orbit's step per frame, carried on past its 20 frames
    poses, _ = orbit_trajectory(n_frames=n_all,
                                radius=1.2 * n_all / n_frames,
                                forward=0.03)
    cam = Camera.create(fx=fx, fy=fx, cx=W / 2, cy=H / 2, bf=0.08 * fx,
                        width=W, height=H, device=dev)
    cfg = SystemConfig(max_keyframes=size["max_keyframes"],
                       max_points=size["max_points"],
                       n_features=size["features"], n_levels=size["levels"],
                       max_frames_between_kf=6, min_init_matches=80,
                       loop_closing=False, pipeline=args.pipeline)
    rgbd = args.sensor == "rgbd"
    sysm = SlamSystem(cam, cfg, Sensor.RGBD if rgbd else Sensor.MONOCULAR,
                      device=dev, seed=args.seed)

    # rendered before anything is timed: the renderer is host numpy
    images = [scene.render(R, t) for R, t in poses]
    depths = [scene.depth_map(R, t) for R, t in poses] if rgbd else None

    def feed(k):
        if rgbd:
            sysm.track_rgbd(images[k], depths[k], k / 30.0)
        else:
            sysm.track_monocular(images[k], k / 30.0)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    frame_ms = []
    for k in range(n_frames):
        sync()
        t0 = time.perf_counter()
        feed(k)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    # the profiler slows the host several times over, so the busy share is
    # taken against the frames just before it, run without it
    plain_ms = statistics.median(frame_ms[-n_prof:])
    img = torch.as_tensor(images[n_frames - 1], device=dev)
    print(f"sensor: {args.sensor}  {W}x{H}  {size['features']} features  "
          f"{size['levels']} levels  "
          f"{'pipelined' if args.pipeline else 'synchronous'} loop")
    print(f"map: {int(sysm.map.n_keyframes())} KFs "
          f"{int(sysm.map.n_points())} pts")

    def ms(fn, n=size["reps"]):
        return med_ms(fn, dev, n)

    n_map = max(1, size["reps"] // 2)

    ext = sysm.extractor
    print(f"extract (cuda kernel={on_card}): {ms(lambda: ext(img)):7.2f} ms")

    # the extractor's parts at level 0
    img0 = img.to(torch.float32).contiguous()
    what = "cuda" if on_card else "plain, no card"
    print(f"  fast_nms_blur L0 ({what}): "
          f"{ms(lambda: kernels.fast_nms_blur(img0, 20.0, 7.0)):7.2f} ms")
    print(f"  fast_score L0 plain: "
          f"{ms(lambda: kernels.fast_score_map(img0, 20.0, 7.0)):7.2f} ms")
    feats = ext(img)
    uv0 = feats.uv[:250] / 1.0
    print(f"  orientations(250): "
          f"{ms(lambda: orb_mod.orientations_from_maps(*orb_mod.orientation_moment_maps(img0), uv0)):7.2f} ms")
    img_b = kernels.gaussian_blur7(img0)
    ang0 = feats.angle[:250]
    print(f"  descriptors(250):  "
          f"{ms(lambda: orb_mod.compute_descriptors(img_b, uv0, ang0)):7.2f} ms")
    print(f"  blur L0 plain:     "
          f"{ms(lambda: kernels.gaussian_blur7(img0)):7.2f} ms")
    h1, w1 = int(round(H / 1.2)), int(round(W / 1.2))
    print(f"  resize L1:         "
          f"{ms(lambda: orb_mod.resize_bilinear(img0, h1, w1)):7.2f} ms")

    # tracking stages on the real map
    if rgbd:
        frame = sysm._make_frame_inputs(
            (img, torch.as_tensor(depths[n_frames - 1], device=dev)))
    else:       # the tracking extractor's budget, also before initialization
        frame = frame_from_features(cam, ext(img))
    tcfg, st, lf = sysm.track_cfg, sysm.map, sysm.last_frame
    if sysm.state != TrackState.OK:
        print(f"state {sysm.state.name} after {n_frames} frames: the "
              f"stages below run on an empty map")
        lf = frame
    ref_kf = max(sysm.last_kf_slot, 0)
    print(f"track_motion_model:  "
          f"{ms(lambda: T.track_motion_model(cam, tcfg, st, frame, lf, lf.pose7)):7.2f} ms")
    print(f"track_ref_kf:        "
          f"{ms(lambda: T.track_reference_keyframe(cam, tcfg, st, frame, ref_kf, lf.pose7)):7.2f} ms")
    f1 = T.track_reference_keyframe(cam, tcfg, st, frame, ref_kf,
                                    lf.pose7)[0]
    print(f"track_local_map:     "
          f"{ms(lambda: T.track_local_map(cam, tcfg, st, f1)):7.2f} ms")
    print(f"track_frame_fused:   "
          f"{ms(lambda: T.track_frame_fused(cam, tcfg, st, frame, lf, lf.pose7, True, ref_kf)):7.2f} ms")

    # insertion + mapping pass, as SlamSystem._insert_keyframe
    mcfg = sysm.map_cfg
    tracked = T.track_frame_fused(cam, tcfg, st, frame, lf, lf.pose7, True,
                                  ref_kf)[1]

    def insert_and_map():
        slot = int(st.free_kf_slot())
        st1, _ = T.insert_keyframe(cam, tcfg, st, tracked, 999, 1.0,
                                   ref_kf, slot)
        return LMM.mapping_pass(cam, mcfg, st1, slot, do_ba=True,
                                do_cull_kf=True)
    print(f"insert_and_map(BA):  {ms(insert_and_map, n=n_map):7.2f} ms")

    # mapping-pass sub-stages, each alone on the same state
    kf = max(sysm.last_kf_slot, 1)
    sub = [
        ("cull_map_points", lambda: LMM.cull_map_points(mcfg, st, kf)),
        ("triangulate", lambda: LMM.triangulate_with_neighbors(
            cam, mcfg, st, kf)),
        ("fuse_neighbors", lambda: LMM.fuse_neighbors(cam, mcfg, st, kf)),
        ("refresh_landmarks", lambda: LMM.refresh_landmarks(mcfg, st, kf)),
        ("local_ba", lambda: LMM.local_ba(cam, mcfg, st, kf)),
        ("cull_keyframes", lambda: LMM.cull_keyframes(mcfg, st, kf)),
    ]
    for name, fn in sub:
        print(f"  {name:18s} {ms(fn, n=n_map):7.2f} ms")

    # steady frames under the profiler
    kernels.fast_nms_blur.launches = 0
    kf0 = sysm.stats["kf_inserted"]
    p = profile_frames(lambda i: feed(n_frames + i), n_prof, dev)
    print(f"profile over {n_prof} steady frames "
          f"(keyframes inserted: {sysm.stats['kf_inserted'] - kf0}, "
          f"state {sysm.state.name}):")
    print(f"  frame wall time: {plain_ms:.2f} ms without the profiler (median "
          f"of the {min(n_prof, n_frames)} frames before), "
          f"{p['wall_ms']:.2f} ms under it")
    if p["device_events"] == 0:
        why = ("the device is the CPU" if not on_card
               else "the profiler recorded no device activity")
        print(f"  no device activity ({why}): the counts below are 0 and "
              f"the busy share is not measured")
    print(f"  kernel launches per frame: {p['launches']:.1f}")
    print(f"  copies and memsets per frame: {p['copies']:.1f}")
    print(f"  synchronizing calls per frame: {p['syncs']:.1f}")
    share = (f"{100.0 * p['busy_ms'] / plain_ms:.2f}% of the frame time "
             f"without the profiler "
             f"({100.0 * p['busy_ms'] / p['wall_ms']:.2f}% under it)"
             if p["device_events"] else "not measured")
    print(f"  device busy per frame: {p['busy_ms']:.2f} ms, share {share}")
    print(f"  fast_nms_blur launches: {kernels.fast_nms_blur.launches}")
    print("  host functions by self time (ms per frame, calls per frame):")
    for ms_f, cnt, name in p["host"]:
        print(f"    {ms_f:9.3f} {cnt:9.1f}  {name}")
    sysm.shutdown()


if __name__ == "__main__":
    main()
