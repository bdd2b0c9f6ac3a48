"""What the eight examples share: the options every example adds, the system
built from a settings file, and the timing report."""

from __future__ import annotations

import argparse
import dataclasses
import time

from ..models.system import Sensor, SlamSystem, SystemConfig
from ..utils.config import camera_from_settings, load_settings


def make_parser(doc: str) -> argparse.ArgumentParser:
    """A parser with the settings file first and the port's two options."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("settings", help="cv::FileStorage settings YAML")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole system (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the RANSAC draws")
    return ap


def open_system(args, sensor: Sensor, **overrides):
    """(settings, system) from `args.settings` on `args.device`;
    `overrides` replace fields of the settings' SystemConfig."""
    s = load_settings(args.settings)
    cam = camera_from_settings(s, device=args.device)
    cfg = SystemConfig.from_settings(s)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return s, SlamSystem(cam, cfg, sensor, device=args.device,
                         seed=args.seed)


def timed(times: list, fn, *fn_args):
    """Call `fn`, append its wall time (the tracking call ends with the
    frame's host read, so the device's work is inside it)."""
    t0 = time.perf_counter()
    out = fn(*fn_args)
    times.append(time.perf_counter() - t0)
    return out


def print_times(times: list, mean: bool = True):
    """The timing lines of the reference's examples (mono_tum.cc:111-120)."""
    tt = sorted(times)
    print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
    if mean:
        print(f"mean tracking time: {sum(tt) / len(tt):.4f}")
