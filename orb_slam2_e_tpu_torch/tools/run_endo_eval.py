"""Deformable relocalization KPI on the endoscopy proxy sequences (twin of
tools/run_endo_eval.py).

The reference's protocol for its deformable extension: build a map on the
surface at rest, then run the breathing sequence in localization-only mode
with `RelocParam.bTestAllFrames`, so that every frame goes through
relocalization, and report the TP / FP / FN precision / recall KPI. Both
phases run the port's `examples.mono_deformable` through `main(argv)`, in
a working directory of their own under the output directory.

Writes `ENDO_KPI.json` (the reference's keys, plus the device, the
textures, the seconds and what the map phase left: frames tracked,
keyframes and landmarks kept, keyframes inserted and culled) and
`StatsReloc_endo.txt` to the output directory; the map goes beside the
map-phase sequence.

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.run_endo_eval [--frames 240]
        [--amp 0.12] [--device cuda] [--data-dir data]
        [--out-dir eval/torch]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import time
from pathlib import Path

from . import make_proxy_endo
from .proxy_render import TEXTURES
from .run_proxy_eval import ROOT, device_line, ensure_sequence, working_dir

KPI_LINE = re.compile(r"reloc KPI: TP=(\d+) FP=(\d+) FN=(\d+) "
                      r"precision=([\d.]+) recall=([\d.]+)")


def run_deformable(argv):
    """`examples.mono_deformable.main(argv)`; returns (printed text,
    seconds, system), the text printed as well."""
    from ..examples import mono_deformable
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        sysm = mono_deformable.main(argv)
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="")
    return out.getvalue(), seconds, sysm


def map_summary(sysm) -> dict:
    """What the map phase left: the map the KPI depends on."""
    return dict(
        map_frames_tracked=sum(p is not None for _, p in sysm.trajectory),
        map_keyframes=sysm.n_keyframes,
        map_landmarks=int(sysm.map.lm_valid.sum()),
        map_kf_inserted=sysm.stats["kf_inserted"],
        map_kf_culled=sysm.stats["kf_culled"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--amp", type=float, default=0.12)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renderer and the systems")
    ap.add_argument("--data-dir", default=str(ROOT / "data"))
    ap.add_argument("--out-dir", default=str(ROOT / "eval" / "torch"))
    args = ap.parse_args(argv)

    data = Path(args.data_dir).resolve()
    d_map = data / "proxy_endo_map"
    d_rel = data / "proxy_endo_reloc"
    for d, phase, amp in ((d_map, "map", 0.0), (d_rel, "reloc", args.amp)):
        ensure_sequence(d, make_proxy_endo, [
            "--phase", phase, "--frames", args.frames, "--amp", args.amp,
            "--device", args.device],
            {"frames": args.frames, "phase": phase, "amp": amp, "seed": 5,
             "textures": list(TEXTURES)})

    evald = Path(args.out_dir).resolve()
    evald.mkdir(parents=True, exist_ok=True)
    common = ["--device", args.device]

    # phase 1: map building, the same settings without the KPI forcing
    settings_map = d_map / "settings_build.yaml"
    settings_map.write_text((d_map / "settings.yaml").read_text().replace(
        "RelocParam.bTestAllFrames: 1", "RelocParam.bTestAllFrames: 0"))
    map_npz = d_map / "endo_map.npz"
    with working_dir(evald):
        _, s_map, sysm = run_deformable([str(settings_map), str(d_map),
                                         "--save-map", str(map_npz),
                                         *common])
    built = map_summary(sysm)
    del sysm

    # phase 2: localization-only relocalization KPI on the breathing surface
    stats = evald / "StatsReloc_endo.txt"
    with working_dir(evald):
        out, s_rel, _ = run_deformable([
            str(d_rel / "settings.yaml"), str(d_rel), "--load-map",
            str(map_npz), "--stats", str(stats), *common])
    m = KPI_LINE.search(out)
    if not m:
        raise RuntimeError("KPI line not found in the example's output")
    kpi = dict(tp=int(m[1]), fp=int(m[2]), fn=int(m[3]),
               precision=float(m[4]), recall=float(m[5]), amp=args.amp,
               frames=args.frames, device=device_line(args.device),
               textures=list(TEXTURES), package="torch",
               seconds_map=round(s_map, 1), seconds_reloc=round(s_rel, 1),
               **built)
    (evald / "ENDO_KPI.json").write_text(json.dumps(kpi, indent=2) + "\n")
    print(json.dumps(kpi))


if __name__ == "__main__":
    main()
