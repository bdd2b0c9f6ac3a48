"""The reference's front end against the program's on the CPU, on frames of
the benchmark's own scene: the frozen copies must give what the program
gives bit for bit (the program's CUDA kernel is bit-equal to its plain
twin, which the CPU runs), and the bfloat16 control must not; the plain
local BA on synthetic windows of known truth and on a window saved from a
run on the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from slambench.reference import ba, check, orb, stereo
from slambench.scenes import sequences
from slambench.scenes.sequences import Sequence
from slambench.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def rgbd():
    cell = tiny_cell("tum1_rgbd.desk_xyz")
    return cell, Sequence(cell.config, cell.mix, 2 ** 31 + 11, "cpu")


@pytest.fixture(scope="module")
def stereo_seq():
    cell = tiny_cell("euroc_stereo.mh_sweep")
    return cell, Sequence(cell.config, cell.mix, 2 ** 31 + 12, "cpu")


def port_extractor(config):
    from orb_slam2_e_tpu_torch.ops.orb import OrbExtractor
    s = config["settings"]
    return OrbExtractor(s["ORBextractor.nFeatures"],
                        s["ORBextractor.scaleFactor"],
                        s["ORBextractor.nLevels"],
                        s["ORBextractor.iniThFAST"],
                        s["ORBextractor.minThFAST"])


def test_extraction_equals_the_program(rgbd):
    cell, seq = rgbd
    ref = check.Reference(cell.config, "cpu")
    img = torch.as_tensor(seq.images[3])
    f = port_extractor(cell.config)(img)
    got = (f.uv, f.octave, f.desc, f.valid)
    want = ref.extract(img)
    assert check.kp_mismatch_pct([(got, want)]) == 0.0
    assert int(f.valid.sum()) > 100
    control = ref.extract(img, torch.bfloat16)
    assert check.kp_mismatch_pct([(control, want)]) > 20.0


def test_depth_sampling_equals_the_program(rgbd):
    from orb_slam2_e_tpu_torch.models.frame import sample_depth_at
    cell, seq = rgbd
    ref = check.Reference(cell.config, "cpu")
    uv, _, _, valid = ref.extract(seq.images[5])
    dm = torch.as_tensor(seq.depths[5])
    got = sample_depth_at(dm, uv, ref.depth_factor)
    want = stereo.sample_depth(dm, uv, ref.depth_factor)
    assert check.depth_mismatch_pct([(got, want, valid)]) == 0.0
    assert int((want[valid] > 0).sum()) > 100
    control = stereo.sample_depth(dm, uv, ref.depth_factor,
                                  dtype=torch.bfloat16)
    assert check.depth_mismatch_pct([(control, want, valid)]) > 20.0


def test_rectification_and_stereo_depth_equal_the_program(stereo_seq):
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    from orb_slam2_e_tpu_torch.ops.stereo import stereo_depth_for_features
    from orb_slam2_e_tpu_torch.utils.rectify import StereoRectifier
    cell, seq = stereo_seq
    s = cell.config["settings"]
    ref = check.Reference(cell.config, "cpu")
    rig = [np.asarray(a) for a in seq.rig()]
    port_rect = StereoRectifier(*rig, s["LEFT.width"], s["LEFT.height"],
                                device="cpu")
    pl, pr = port_rect(seq.images[4], seq.rights[4])
    rl, rr = ref.rectify(seq.images[4], seq.rights[4])
    assert float((pl - rl).abs().max()) == 0.0
    assert float((pr - rr).abs().max()) == 0.0
    bl, _ = ref.rectify(seq.images[4], seq.rights[4], torch.bfloat16)
    assert float((bl.float() - rl).abs().max()) > 0.1
    ex = port_extractor(cell.config)
    feats = ex(rl)
    cam = Camera.create(fx=s["Camera.fx"], fy=s["Camera.fy"],
                        cx=s["Camera.cx"], cy=s["Camera.cy"],
                        bf=s["Camera.bf"], width=s["Camera.width"],
                        height=s["Camera.height"])
    from orb_slam2_e_tpu_torch.ops.orb import OrbExtractor
    right = OrbExtractor(ex.capacity, s["ORBextractor.scaleFactor"],
                         s["ORBextractor.nLevels"])
    got = stereo_depth_for_features(cam, rl, rr, feats,
                                    s["ORBextractor.scaleFactor"], right)
    left = (feats.uv, feats.octave, feats.desc, feats.valid)
    want = ref.stereo_depth(left, rl, rr)
    assert check.depth_mismatch_pct([(got, want, feats.valid)]) == 0.0
    assert int((want > 0).sum()) > 50
    control = ref.stereo_depth(left, rl, rr, torch.bfloat16)
    assert check.depth_mismatch_pct([(control, want, feats.valid)]) > 20.0


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from slambench import harness
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "orb_slam2_e_tpu_torch", "orb_slam2_e_tpu", "jax",
                    "jaxlib", "flax"), (path.name, n)
    assert orb.Extractor


def _ba_window(noise: float, seed: int = 0):
    """A synthetic local-BA window: 4 stereo keyframes (the first held)
    around 200 landmarks; the start is the truth with `noise` added to the
    free poses' translations and to the landmarks."""
    g = torch.Generator().manual_seed(seed)
    C, P = 4, 200
    X = torch.rand(P, 3, generator=g, dtype=torch.float64) * torch.tensor(
        [4.0, 3.0, 2.0], dtype=torch.float64) + torch.tensor(
        [-2.0, -1.5, 3.0], dtype=torch.float64)
    R = torch.stack([sequences_rot(0.05 * c) for c in range(C)])
    t = torch.tensor([[0.2 * c, 0.05 * c, 0.0] for c in range(C)],
                     dtype=torch.float64)
    cam = (500.0, 500.0, 320.0, 240.0, 40.0)
    oc = torch.arange(C).repeat_interleave(P)
    op = torch.arange(P).repeat(C)
    xc = torch.einsum("oij,oj->oi", R[oc], X[op]) + t[oc]
    u = cam[0] * xc[:, 0] / xc[:, 2] + cam[2]
    v = cam[1] * xc[:, 1] / xc[:, 2] + cam[3]
    uvr = torch.stack([u, v, u - cam[4] / xc[:, 2]], -1)
    prob = {"cam_free": torch.tensor([False, True, True, True]),
            "point_valid": torch.ones(P, dtype=torch.bool),
            "obs_cam": oc, "obs_point": op, "obs_uvr": uvr,
            "obs_inv_sigma2": torch.ones(C * P, dtype=torch.float64),
            "obs_valid": torch.ones(C * P, dtype=torch.bool)}
    t0 = t + noise * torch.randn(C, 3, generator=g, dtype=torch.float64
                                 ) * prob["cam_free"][:, None]
    X0 = X + noise * torch.randn(P, 3, generator=g, dtype=torch.float64)
    truth = (R, t, X)
    return cam, ba.Window(prob, (R, t0, X0), truth, "cpu"), truth


def sequences_rot(a: float) -> torch.Tensor:
    return torch.as_tensor(sequences.so3_exp([0.0, a, 0.0]))


def test_reference_ba_reaches_the_truth():
    cam, w, truth = _ba_window(0.01)
    (R, t, X), inliers = ba.local_ba(cam, w)
    assert bool(inliers.all())
    assert ba.cost(cam, w, w.start) > 100.0
    assert ba.cost(cam, w, (R, t, X)) < 1e-6
    assert float((X - truth[2]).abs().max()) < 1e-4


def test_shortfall_reads_0_at_the_optimum_and_1_at_the_start():
    cam, w, truth = _ba_window(0.01)
    assert ba.shortfall(cam, [w]) == pytest.approx(0.0, abs=1e-6)
    w.result = w.start
    assert ba.shortfall(cam, [w]) == pytest.approx(1.0)
    assert ba.shortfall(cam, []) is None


def test_shortfall_of_the_bfloat16_control_is_high():
    cam, w, truth = _ba_window(0.01)
    assert ba.shortfall(cam, [w], control=True) > 0.1


# a local BA of the program in a 210 s run of `euroc_stereo.mh_sweep` on
# the card (seed 2147485350, during frame 110): its problem, its start and
# the map the mapping pass left. Its 12,288 observations fill the
# problem's capacity before the last of its 16 free keyframes
SAVED = Path(__file__).parent / "data" / "mh_sweep_window_2147485350_f110.pt"


@pytest.fixture(scope="module")
def saved():
    d = torch.load(SAVED)
    return tuple(d["cam"]), d


def _saved_window(d):
    return ba.Window(d["prob"], d["start"], d["result"], "cpu")


def test_saved_window_solves_and_holds_the_unobserved_keyframe(saved):
    cam, d = saved
    w = _saved_window(d)
    seen = torch.bincount(w.oc[w.valid], minlength=w.free.shape[0]) > 0
    assert int(w.valid.sum()) == w.valid.shape[0] == 12288
    assert (w.free & ~seen).nonzero().flatten().tolist() == [15]
    (R, t, X), inliers = ba.local_ba(cam, w)
    assert torch.equal(R[15], w.start[0][15])
    assert torch.equal(t[15], w.start[1][15])
    moved = (t[:15] - w.start[1][:15]).abs().amax(-1)
    assert bool((moved > 0).all())
    assert ba.cost(cam, w, (R, t, X)) < ba.cost(cam, w, w.start)
    short = ba.shortfall(cam, [w])
    # 1.5e-4 on an x86 CPU, 0.1 the cell's limit
    assert np.isfinite(short) and 0.0 <= short < 1e-3


def test_control_over_the_saved_window_is_high(saved):
    cam, d = saved
    # 38.07 on an x86 CPU, 0.1 the cell's limit
    assert ba.shortfall(cam, [_saved_window(d)], control=True) > 1.0


def test_match_rows_finds_bit_equal_rows():
    table = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    rows = torch.tensor([[5.0, 6.0], [1.0, 2.0], [7.0, 8.0]])
    assert ba.match_rows(table, rows).tolist() == [2, 0, -1]


@pytest.mark.parametrize("kind", ["clipped", "gated"])
def test_free_keyframe_without_live_observation_is_held(kind):
    """A free keyframe whose observations are all left out of the problem
    (the program's observation capacity), or all gross outliers, has a zero
    block in the reduced camera system at every step: the reference holds
    it where it once found the system singular, and solves the rest."""
    cam, w, truth = _ba_window(0.01)
    off = w.oc == 3
    if kind == "clipped":
        w.valid = w.valid & ~off
    else:
        w.uvr = w.uvr + 300.0 * off[:, None] * torch.tensor(
            [1.0, 0.0, 1.0], dtype=torch.float64)
    (R, t, X), inliers = ba.local_ba(cam, w)
    assert torch.equal(R[3], w.start[0][3]) and torch.equal(t[3],
                                                            w.start[1][3])
    assert not bool(inliers[off].any())
    assert float((t[1:3] - truth[1][1:3]).abs().max()) < 1e-9
    assert ba.shortfall(cam, [w]) == pytest.approx(0.0, abs=1e-6)
    assert ba.shortfall(cam, [w], control=True) > 0.1


# the pre-repair reference's readings of two regular windows (every free
# keyframe observed), as float.hex: the repair must leave them bit-equal
REGULAR = {"exact": ("0x1.08fb252fa0000p-61", "0x1.a2c7fd41cf4cep-2",
                     "0x1.5173543b82fe9p-2"),
           "noisy": ("0x1.b58e56a091cd6p+8", None, "0x1.42497151a730cp-2")}


@pytest.mark.parametrize("name", sorted(REGULAR))
def test_regular_window_reads_as_before_the_repair(name):
    cam, w, truth = _ba_window(0.01)
    if name == "noisy":
        g = torch.Generator().manual_seed(1)
        w.uvr = w.uvr + 0.5 * torch.randn(w.uvr.shape, generator=g,
                                          dtype=torch.float64)
    c_ref, mid, control = REGULAR[name]
    assert ba.cost(cam, w, ba.local_ba(cam, w)[0]).hex() == c_ref
    assert ba.shortfall(cam, [w], control=True).hex() == control
    if mid is not None:
        w.result = tuple(0.5 * (a + b) for a, b in zip(w.start, truth))
        assert ba.shortfall(cam, [w]).hex() == mid
