"""The benchmark's shared machinery: finding a cell's files by name, the
spans and captures around calls into the program, the result line and the
check that no JAX module was loaded.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`);
the mix names its driver (`traffic/<kind>.py`), and the cell's own file
(`cells/<cell>.json`) holds the limits of its checks and its ATE frames.
A per-layer metric is read by `metrics/<metric>.py`. Nothing here is
specific to one cell.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_e_tpu")
CACHE_DIR = ROOT / ".slambench_cache"


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of FORBIDDEN: `orb_slam2_e_tpu_torch.x` is not one."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def set_cache_dirs():
    """Keep every build and kernel cache the program could use at a fixed
    path inside the checkout, so that a second run finds it built. The
    program builds its own CUDA kernels into its `build/` folder."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything one workload of BENCHMARK.json names, loaded by name."""

    def __init__(self, name: str, root: Path = ROOT, entry=None):
        """`entry`: the workload's entry where BENCHMARK.json has none (a
        cell whose files are kept for a later benchmark, run by the tests)."""
        bench = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if entry is None and name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = entry or entries[name]
        self.name = name
        self.chips = int(w["chips"])
        self.config = load_json(HERE / "configs" / f"{w['config']}.json")
        self.mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.file = load_json(HERE / "cells" / f"{name}.json")

        def wanted(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if wanted(m)]
        self.per_layer = [m for m in bench["per_layer"] if wanted(m)]

    def driver(self):
        return importlib.import_module(
            f"slambench.traffic.{self.mix['kind']}")


def metric_reader(name: str):
    """The `read(trace)` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log_setup(t_start: float, marks):
    """One line on standard error: the seconds of each part of set-up,
    the first being imports and process start-up to the driver."""
    parts = [f"imports {marks[0][1] - t_start:.2f}"] + [
        f"{name} {t - t0:.2f}" for (_, t0), (name, t) in zip(marks, marks[1:])]
    print("setup_s parts: " + ", ".join(parts), file=sys.stderr)


def reset_peak(device):
    """Free the set-up's own device memory and start the peak anew."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Hooks:
    """Wrappers around calls into the program, installed once per run.

    `mode` is "off" (pass through), "sync" (a span timed on the host clock
    between `torch.cuda.synchronize()` calls; they take the pipelined
    loop's overlap away, so these are traced runs only) or "annotate" (a
    `torch.profiler.record_function` range `slambench.<span>`). A capture
    callback sees every output while `capturing` is set, in any mode."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.mode = "off"
        self.capturing = False
        self.spans = defaultdict(list)
        self.calls = defaultdict(int)    # calls per span, in every mode
        self.recording = False
        self.paused = 0.0                # seconds in `profile_first` sessions
        self._installed = []

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def wrap(self, owner, attr: str, span, on_out=None, idle=None):
        """Replace `owner.attr` by a wrapper. `idle(when)` ("before" or
        "after" the call) says that a call had nothing to do, so it is no
        sample of its span. With `span` None the wrapper only captures."""
        fn = getattr(owner, attr)
        torch = self.torch

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if span is not None:
                self.calls[span] += 1
            if span is None or self.mode == "off":
                out = fn(*args, **kwargs)
            elif self.mode == "sync":
                quiet = idle is not None and idle("before")
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                dt = time.perf_counter() - t0
                if not quiet and not (idle is not None and idle("after")):
                    self.spans[span].append(dt * 1e3)
            else:
                with torch.profiler.record_function("slambench." + span):
                    out = fn(*args, **kwargs)
            if on_out is not None and self.capturing:
                on_out(out, args)
            return out

        self._installed.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, wrapper)

    def record(self, owner, attr: str) -> list:
        """Replace `owner.attr` by a wrapper that, while `recording`, keeps
        the positional arguments of every call (the kernels' inputs in a
        profiled stretch) in the list it returns."""
        fn = getattr(owner, attr)
        calls = []

        # `wraps` carries the function's attributes over, such as the
        # launch counters the program keeps on its kernel entry points
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.recording:
                calls.append(args)
            return fn(*args, **kwargs)

        self._installed.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, wrapper)
        return calls

    def profile_first(self, owner, attr: str, n: int, calls: list) -> list:
        """Replace `owner.attr` by a wrapper that runs each of its first `n`
        calls made while `capturing` inside a torch.profiler session of its
        own, the device synchronized on both sides, `recording` on and every
        span quiet (mode "off": such a call is no sample of its span). The
        list returned gets one (profile, calls, seconds) per session: the
        closed profiler, whose events are read later; what `calls` (a list
        that `record` fills) took in during the session, which empties it;
        and the session's wall seconds, its start and stop included, which
        `paused` adds up."""
        fn = getattr(owner, attr)
        sessions = []

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self.capturing or len(sessions) >= n:
                return fn(*args, **kwargs)
            mode, recording = self.mode, self.recording
            self.mode, self.recording = "off", True
            t0 = time.perf_counter()
            try:
                self.sync()
                with _profile() as prof:
                    out = fn(*args, **kwargs)
                    self.sync()
            finally:
                self.mode, self.recording = mode, recording
            dt = time.perf_counter() - t0
            self.paused += dt
            sessions.append((prof, list(calls), dt))
            calls.clear()
            return out

        self._installed.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, wrapper)
        return sessions

    def remove(self):
        for owner, attr, old in reversed(self._installed):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._installed = []


class Trace:
    """What a traced run hands the per-layer metric readers."""

    def __init__(self):
        self.spans = {}          # span -> [ms] over the traced window
        self.events = None       # reference.trace.Events of the stretch
        self.stretch = {}        # frames, wall_s, t0_us, t1_us
        self.fast_nms_blur_bounds_s = []
        # (Events, segment_sum bounds [s]) of each mapping pass profiled in
        # a session of its own at the window's start
        self.captures = []


def _profile():
    """A torch.profiler session of host and device activity, after which
    the device tracer (CUPTI) is torn down (`TEARDOWN_CUPTI=1`): left
    attached, it slowed every later frame of the port by a quarter or more
    on the H100."""
    from torch.profiler import ProfilerActivity, profile
    os.environ["TEARDOWN_CUPTI"] = "1"
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler(hooks: Hooks):
    """Open and close one profiler session around a single device op, so
    that the device tracer's one-off start (seconds on the card) falls in
    set-up rather than in the first session that measures."""
    import torch
    with _profile():
        torch.ones(1, device=hooks.device).add_(1)
        hooks.sync()


def profile_stretch(step, more, hooks: Hooks):
    """Run `step(i)` for i = 0, 1, ... while `more(i)` under torch.profiler
    with the hooks annotating. Returns (Events, steps run, wall seconds,
    first and last host microsecond of the stretch)."""
    import torch
    from .reference.trace import Events
    hooks.sync()
    hooks.mode = "annotate"
    with _profile() as prof:
        with torch.profiler.record_function("slambench.stretch"):
            t0 = time.perf_counter()
            i = 0
            while more(i):
                with torch.profiler.record_function("slambench.frame"):
                    step(i)
                i += 1
            hooks.sync()
            wall = time.perf_counter() - t0
    hooks.mode = "off"
    ev = Events.from_profiler(prof)
    st = [(s, e) for name, s, e in ev.host if name == "slambench.stretch"]
    return ev, i, wall, st[0][0], st[0][1]


def result_line(cell: Cell, out: dict, trace: bool, device_name: str,
                device_count: int) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and checks, last."""
    from .reference.check import verdict
    correct, checks = verdict(out["numbers"], cell.file["limits"])
    metrics = {}
    on_card = device_name != "cpu"    # a CPU run writes no device metric
    for m in (cell.per_layer if trace else cell.end_to_end) if on_card else ():
        v = (metric_reader(m["name"])(out["trace"]) if trace
             else out["end_to_end"].get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
              "count": device_count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and on_card:
        tr = out["trace"]
        ev = tr.events
        device["busy_s"] = ev.busy_us() * 1e-6
        device["window_s"] = tr.stretch["wall_s"]
        line["breakdown"] = {
            "device_ops": ev.top_device_ops(10),
            "idle_gaps": ev.idle_gaps(tr.stretch["t0_us"],
                                      tr.stretch["t1_us"], 10)}
    line["checks"] = checks
    return line


def stderr_lines(out: dict, line: dict):
    """The run's last lines on standard error: numbers that are no metric
    of the cell (the ATE), then each compared number beside its limit."""
    for name, v in out.get("info", {}).items():
        print(f"info {name} {v}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
