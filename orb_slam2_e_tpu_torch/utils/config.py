"""Settings loader for the reference's cv::FileStorage YAML schema.

Port of `orb_slam2_e_tpu/utils/config.py`: the same files (Camera.*,
ORBextractor.*, ThDepth, DepthMapFactor, RelocParam.*, Viewer.*,
Output.StatsReloc, and the LEFT.* / RIGHT.* rectification matrices of a
stereo config) give the same `Settings`. The reference parses with PyYAML;
this module reads the subset that settings files use with its own reader
and needs nothing outside the standard library and numpy.

What the reader accepts:

- a first line `%YAML:1.0` (optional), optionally followed by `---`;
- blank lines and `#` comments (a whole line, or after a value behind
  white space);
- `Key.sub: value` at column 0, where the value is a decimal integer
  (`20`, `-3`, `1_000`), a float with a dot (`20.0`, `1.`, `.5`, `1.0e-3`),
  a `yes/no/true/false/on/off` word (a bool), `~` / `null` / nothing
  (None), a single- or double-quoted string, or a bare string. As in
  PyYAML's YAML 1.1 rules a number without a dot or with an unsigned
  exponent (`1e-3`, `1.0e3`) is a string; `load_settings` casts every
  schema key through its default's type, so `1e-3` still arrives as 0.001;
- `Key: !!opencv-matrix` followed by an indented block with `rows`,
  `cols`, `dt` and a flow list `data: [ ... ]` that may run over several
  lines; it becomes a float64 array of shape (rows, cols).

What it refuses, with a ValueError naming the line: anything else: nested
mappings, block lists, anchors and tags other than `!!opencv-matrix`,
multi-line strings, and the YAML 1.1 number forms that settings files do
not use (octal such as `007`, hexadecimal, binary, sexagesimal `1:30`,
dates, `.inf`, `.nan`). A line it cannot read is never skipped.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

import numpy as np


@dataclasses.dataclass
class OrbParams:
    """ORBextractor.* keys (reference src/Tracking.cc:119-138)."""
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class RelocParams:
    """RelocParam.* keys (reference src/Tracking.cc:162-175)."""
    test_all_frames: bool = False
    n_precision_frames: int = 2
    use_inverse: bool = False
    el_type: int = 1          # 1 = C3D6 prisms, 2 = C3D8 hexahedra


@dataclasses.dataclass
class Settings:
    # Camera.* (reference src/Tracking.cc:53-117)
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: bool = True
    bf: float = 0.0
    width: int = 640
    height: int = 480
    th_depth: float = 35.0          # ThDepth: close/far stereo point gate
    depth_map_factor: float = 1.0   # DepthMapFactor: RGB-D depth scaling
    orb: OrbParams = dataclasses.field(default_factory=OrbParams)
    orb_ini: Optional[OrbParams] = None  # mono init: 2x features
    reloc: RelocParams = dataclasses.field(default_factory=RelocParams)
    viewer: dict = dataclasses.field(default_factory=dict)
    stats_reloc: Optional[str] = None    # Output.StatsReloc log path

    def __post_init__(self):
        if self.orb_ini is None:
            self.orb_ini = dataclasses.replace(
                self.orb, n_features=2 * self.orb.n_features)


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------

_BOOLS = {w: v for v, ws in ((True, ("yes", "true", "on")),
                             (False, ("no", "false", "off")))
          for base in ws for w in (base, base.capitalize(), base.upper())}
_NULLS = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
# YAML 1.1 forms PyYAML would type as numbers or dates and this reader does
# not: refused rather than read as something else
_EXOTIC = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?)$")
_KEY = re.compile(r"([^\s:#'\"!&*\[\]{},][^:]*?)\s*:(?:\s+(.*))?$")


def _fail(n: int, line: str, why: str):
    raise ValueError(f"settings line {n}: {why}: {line!r}")


def _strip_comment(line: str) -> str:
    """Drop a `#` comment: at the start, or behind white space, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, n: int, line: str):
    """One plain or quoted scalar, typed as PyYAML's SafeLoader types it."""
    t = text.strip()
    if t[:1] == '"':
        if len(t) < 2 or t[-1] != '"':
            _fail(n, line, "unterminated double-quoted string")
        return t[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if t[:1] == "'":
        if len(t) < 2 or t[-1] != "'":
            _fail(n, line, "unterminated single-quoted string")
        return t[1:-1].replace("''", "'")
    if t in _NULLS:
        return None
    if t in _BOOLS:
        return _BOOLS[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _EXOTIC.match(t):
        _fail(n, line, "number or date form not accepted")
    if t[0] in "!&*[]{}|>%@`" or ": " in t:
        _fail(n, line, "unsupported YAML construct")
    return t


def _matrix(fields: dict, n: int, line: str) -> np.ndarray:
    for k in ("rows", "cols", "data"):
        if k not in fields:
            _fail(n, line, f"!!opencv-matrix without `{k}`")
    rows, cols = int(fields["rows"]), int(fields["cols"])
    data = np.asarray(fields["data"], dtype=np.float64)
    if data.size != rows * cols:
        _fail(n, line, f"!!opencv-matrix holds {data.size} values, "
                       f"not {rows} x {cols}")
    return data.reshape(rows, cols)


def parse(text: str) -> dict:
    """Settings text -> key -> value dict (matrices as float64 arrays)."""
    lines = text.split("\n")
    start = 0
    if lines and lines[0].startswith("%YAML"):
        start = 1
    out: dict = {}
    i = start
    seen_content = False
    while i < len(lines):
        n, raw = i + 1, lines[i]
        line = _strip_comment(raw).rstrip()
        i += 1
        if not line.strip():
            continue
        if line == "---" and not seen_content:
            seen_content = True
            continue
        seen_content = True
        if line[0] in " \t":
            _fail(n, raw, "indented line outside an !!opencv-matrix block")
        m = _KEY.match(line)
        if not m:
            _fail(n, raw, "not a `key: value` line")
        key, val = m.group(1), (m.group(2) or "").strip()
        if not val.startswith("!!"):
            out[key] = _scalar(val, n, raw)
            continue
        if val != "!!opencv-matrix":
            _fail(n, raw, "unsupported tag")
        # the indented block of the matrix
        fields: dict = {}
        while i < len(lines):
            sub_raw = lines[i]
            sub = _strip_comment(sub_raw).rstrip()
            if not sub.strip():
                i += 1
                continue
            if sub[0] not in " \t":
                break
            sn = i + 1
            i += 1
            sm = _KEY.match(sub.strip())
            if not sm:
                _fail(sn, sub_raw, "not a `key: value` line")
            skey, sval = sm.group(1), (sm.group(2) or "").strip()
            if skey != "data":
                fields[skey] = _scalar(sval, sn, sub_raw)
                continue
            if not sval.startswith("["):
                _fail(sn, sub_raw, "`data` must be a flow list [ ... ]")
            body = sval[1:]
            while "]" not in body:
                if i >= len(lines):
                    _fail(sn, sub_raw, "unterminated `data` list")
                body += " " + _strip_comment(lines[i]).strip()
                i += 1
            body, tail = body.split("]", 1)
            if tail.strip():
                _fail(sn, sub_raw, "text after the `data` list")
            items = [p.strip() for p in body.split(",")]
            if items[-1] == "":
                items.pop()                   # trailing comma
            fields["data"] = [_scalar(s, sn, sub_raw) for s in items]
        out[key] = _matrix(fields, n, raw)
    return out


def load_raw(path: str | Path) -> dict:
    """Raw key -> value dict of a cv::FileStorage YAML (matrices as
    numpy)."""
    return parse(Path(path).read_text())


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    return type(default)(v) if v is not None else default


def stereo_rectifier_from_settings(path: str | Path, *, device):
    """Build a StereoRectifier, its maps on `device`, from the LEFT.* /
    RIGHT.* blocks of a stereo config (reference stereo_euroc.cc:59-105
    reads the same keys); None when a block is missing."""
    d = load_raw(path)
    from .rectify import StereoRectifier
    need = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
            "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P",
            "LEFT.width", "LEFT.height"]
    if any(k not in d for k in need):
        return None
    return StereoRectifier(
        d["LEFT.K"], d["LEFT.D"], d["LEFT.R"], d["LEFT.P"],
        d["RIGHT.K"], d["RIGHT.D"], d["RIGHT.R"], d["RIGHT.P"],
        int(d["LEFT.width"]), int(d["LEFT.height"]), device=device)


def load_settings(path: str | Path) -> Settings:
    d = load_raw(path)
    orb = OrbParams(
        n_features=int(_get(d, 'ORBextractor.nFeatures', 1000)),
        scale_factor=float(_get(d, 'ORBextractor.scaleFactor', 1.2)),
        n_levels=int(_get(d, 'ORBextractor.nLevels', 8)),
        ini_th_fast=int(_get(d, 'ORBextractor.iniThFAST', 20)),
        min_th_fast=int(_get(d, 'ORBextractor.minThFAST', 7)),
    )
    reloc = RelocParams(
        test_all_frames=bool(int(_get(d, 'RelocParam.bTestAllFrames', 0))),
        n_precision_frames=int(_get(d, 'RelocParam.nPrecisionFrames', 2)),
        use_inverse=bool(int(_get(d, 'RelocParam.bUseInverse', 0))),
        el_type=int(_get(d, 'RelocParam.nElType', 1)),
    )
    return Settings(
        fx=float(_get(d, 'Camera.fx', 500.0)),
        fy=float(_get(d, 'Camera.fy', 500.0)),
        cx=float(_get(d, 'Camera.cx', 320.0)),
        cy=float(_get(d, 'Camera.cy', 240.0)),
        k1=float(_get(d, 'Camera.k1', 0.0)),
        k2=float(_get(d, 'Camera.k2', 0.0)),
        p1=float(_get(d, 'Camera.p1', 0.0)),
        p2=float(_get(d, 'Camera.p2', 0.0)),
        k3=float(_get(d, 'Camera.k3', 0.0)),
        fps=float(_get(d, 'Camera.fps', 30.0)),
        rgb=bool(int(_get(d, 'Camera.RGB', 1))),
        bf=float(_get(d, 'Camera.bf', 0.0)),
        width=int(_get(d, 'Camera.width', 640)),
        height=int(_get(d, 'Camera.height', 480)),
        th_depth=float(_get(d, 'ThDepth', 35.0)),
        depth_map_factor=float(_get(d, 'DepthMapFactor', 1.0)),
        orb=orb,
        reloc=reloc,
        viewer={k: v for k, v in d.items() if k.startswith('Viewer.')},
        stats_reloc=d.get('Output.StatsReloc'),
    )


def camera_from_settings(s: Settings, *, device):
    from ..ops.camera import Camera
    return Camera.create(s.fx, s.fy, s.cx, s.cy, s.k1, s.k2, s.p1, s.p2, s.k3,
                         s.bf, s.width, s.height, device=device)
