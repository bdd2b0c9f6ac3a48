"""The port's tools on the CPU at a small size: `profile_step` prints every
stage the reference's tool prints and the profile of steady frames;
`train_vocab` writes a vocabulary file that both packages load."""

import os
import re

import cv2
import numpy as np
import pytest

import _torch_port  # noqa: F401  (thread settings)
from orb_slam2_e_tpu_torch.ops import bow
from orb_slam2_e_tpu_torch.tools import profile_step, train_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the stage names of tools/profile_step.py's lines, in its order ("xla" is
# "plain" here)
STAGES = ["extract", "fast_nms_blur L0", "fast_score L0", "orientations(250)",
          "descriptors(250)", "blur L0", "resize L1", "track_motion_model",
          "track_ref_kf", "track_local_map", "track_frame_fused",
          "insert_and_map(BA)", "cull_map_points", "triangulate",
          "fuse_neighbors", "refresh_landmarks", "local_ba",
          "cull_keyframes"]
SMALL = ["--device", "cpu", "--small"]


def test_stage_names_are_the_reference_tools():
    """STAGES above is what the reference's tool prints."""
    with open(os.path.join(REPO, "tools", "profile_step.py")) as f:
        src = f.read()
    printed = re.findall(r'print\(f"\s*([\w()+ ]+?)(?: \(pallas|:| xla:)', src)
    printed += re.findall(r'\("(\w+)", lambda: LMM\.', src)
    assert [p for p in printed if p != "map"] == STAGES


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_profile_step(sensor, capsys):
    profile_step.main(SMALL + ["--sensor", sensor])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "device: cpu (no card: host times)"
    assert re.fullmatch(r"map: \d+ KFs \d+ pts", lines[2])
    pos = -1
    for name in STAGES:                       # every stage, in order, in ms
        found = [i for i, ln in enumerate(lines)
                 if ln.strip().startswith(name)
                 and re.search(r"\d+\.\d{2} ms", ln)]
        assert len(found) == 1 and found[0] > pos, (name, out)
        pos = found[0]
    assert "fast_nms_blur L0 (plain, no card)" in out
    # the profile: on the CPU the device counts are 0, and it says so
    assert "profile over 2 steady frames" in out
    assert "no device activity (the device is the CPU)" in out
    for what in ("kernel launches per frame: 0.0",
                 "copies and memsets per frame: 0.0",
                 "synchronizing calls per frame: 0.0",
                 "share not measured", "fast_nms_blur launches: 0"):
        assert what in out, what
    host = lines[lines.index("  host functions by self time (ms per frame, "
                             "calls per frame):") + 1:]
    assert len(host) == 10
    assert all(re.fullmatch(r"\s+\d+\.\d{3}\s+\d+\.\d\s+\S.*", ln)
               for ln in host)
    if sensor == "rgbd":
        assert int(lines[2].split()[1]) >= 2      # a map was built


def test_profile_step_pipelined(capsys):
    """`--pipeline` builds the map and profiles the frames through the
    pipelined loop."""
    profile_step.main(SMALL + ["--sensor", "rgbd", "--pipeline"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].endswith("pipelined loop")
    assert int(lines[2].split()[1]) >= 2
    assert any(ln.startswith("profile over 2 steady frames") for ln in lines)
    # the program's spans: the table's header, then a row per span name
    head = lines.index("  program spans (per frame: calls, host ms, self "
                       "ms, launches and synchronizing calls inside):")
    assert lines[head + 1].split() == ["span", "calls", "host", "ms", "self",
                                       "ms", "launches", "syncs"]
    rows = {ln.split()[0]: [float(v) for v in ln.split()[1:]]
            for ln in lines[head + 2:] if re.fullmatch(
                r"    [a-z_.]+( +\d+\.\d+){5}", ln)}
    assert rows["frame"][0] == 1.0 and rows["track.pose_lm"][0] == 3.0
    assert rows["frame"][1] >= rows["track"][1] > 0


def test_busy_union_counts_overlap_once():
    assert profile_step._union_us([]) == 0.0
    assert profile_step._union_us([(0, 10), (5, 12), (20, 21), (3, 4)]) == 13


def test_train_vocab(tmp_path, capsys):
    for k in range(2):                         # two real images for --images
        img = np.random.RandomState(k).randint(0, 255, (120, 160)).astype(
            np.uint8)
        cv2.imwrite(str(tmp_path / f"tex{k}.png"),
                    cv2.GaussianBlur(img, (0, 0), 1.5))
    out_file = tmp_path / "out" / "vocab.npz"
    train_vocab.main(["--k", "4", "--L", "2", "--scenes", "2", "--frames",
                      "2", "--features", "300", "--iters", "2", "--images",
                      str(tmp_path), "--out", str(out_file), "--device",
                      "cpu"])
    out = capsys.readouterr().out
    assert "scene 2/2: corpus" in out and "images 2: corpus" in out
    assert re.search(r"corpus: \d+ descriptors from 12 frames", out)
    assert "trained k=4 L=2 -> 16 words" in out
    assert re.search(r"BoW discrimination over 12 frames: top-1 \d\.\d{3} vs "
                     r"median \d\.\d{3} \(margin -?\d\.\d{3}\)", out)
    assert f"saved {out_file}" in out
    voc = bow.load_vocabulary(out_file, device="cpu")
    assert (voc.k, voc.L, voc.n_words) == (4, 2, 16)
    assert voc.node_bits.shape == (4 + 16, 256) and voc.idf.shape == (16,)
    with np.load(out_file) as d:
        assert {"meta_margin", "meta_corpus", "meta_docs"} <= set(d)
        assert int(d["meta_docs"]) == 12
    # the reference loads the same file
    from orb_slam2_e_tpu.ops import bow as jbow
    jv = jbow.load_vocabulary(out_file)
    np.testing.assert_array_equal(np.asarray(jv.node_bits),
                                  voc.node_bits.numpy())
    # and a system takes it through SystemConfig.vocab_path
    from orb_slam2_e_tpu_torch.models.system import (Sensor, SlamSystem,
                                                     SystemConfig)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    st = SlamSystem(Camera.create(260, 260, 160, 120, width=320, height=240),
                    SystemConfig(vocab_path=str(out_file), max_keyframes=8,
                                 max_points=1024), Sensor.RGBD, device="cpu")
    assert st.vocab.n_words == 16 and st.bow_db is not None


def test_train_vocab_needs_images(tmp_path):
    with pytest.raises(FileNotFoundError, match="no PNG or JPEG"):
        train_vocab.build_real_corpus(tmp_path, 100, 0, device="cpu")
