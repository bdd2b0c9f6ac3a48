"""The port's distributed BA (`parallel/dist_ba.py`) on 2 and 4 gloo ranks
on the CPU, against the port's single-process solve and the reference's
`distributed_ba` on the 8-device virtual CPU mesh: the twins of
tests/test_parallel.py. The ranks run once per world size, in spawned
processes (tests/_torch_dist.py); a rank that hangs fails the run after
120 s."""

import numpy as np
import pytest
import jax
import torch

import _torch_dist
from _torch_port import jnp_dict, tnp
from orb_slam2_e_tpu.parallel import dist_ba as jdist
from orb_slam2_e_tpu_torch.ops import ba as tba
from orb_slam2_e_tpu_torch.parallel import dist_ba
from orb_slam2_e_tpu_torch.utils import convert
from test_ba import make_ba_problem, _pose_errors

WORLDS = [2, 4]
POSE_ATOL, POINT_ATOL = 5e-4, 5e-3     # tests/test_parallel.py:29-37
SEEDS = {"match": 7, "converge": 8}


@pytest.fixture(scope="module")
def problems():
    return {tag: make_ba_problem(seed=seed) for tag, seed in SEEDS.items()}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """{world: [each rank's results]}"""
    root = tmp_path_factory.mktemp("dist_ba")
    arrays = {}
    for tag, (cam, prob, *_) in problems.items():
        arrays.update({f"{tag}.cam.{k}": v for k, v in jnp_dict(cam).items()})
        arrays.update({f"{tag}.prob.{k}": v
                       for k, v in jnp_dict(prob).items()})
    np.savez(root / "inputs.npz", **arrays)
    return _torch_dist.spawn(_torch_dist.rank_ba, WORLDS,
                             root / "inputs.npz", root)


def _port(cam, prob):
    return (convert.camera_from_numpy(jnp_dict(cam), "cpu"),
            convert.ba_problem_from_numpy(jnp_dict(prob), "cpu"))


@pytest.fixture(scope="module")
def single(problems):
    cam, prob, *_ = problems["match"]
    return tba.ba_solve_pcg(*_port(cam, prob), **_torch_dist.MATCH)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_matches_single_process(ranks, single, world):
    got = ranks[world][0]
    np.testing.assert_allclose(got["match.cam_pose7"], tnp(single.cam_pose7),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got["match.points"], tnp(single.points),
                               atol=POINT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_matches_reference_mesh(ranks, problems, world):
    """The reference's distributed_ba on its virtual CPU mesh (8 devices
    where the conftest's flag took), same problem, same settings."""
    cam, prob, *_ = problems["match"]
    mesh = jdist.make_mesh(min(8, len(jax.devices())))
    ref = jdist.distributed_ba(cam, prob, mesh, **_torch_dist.MATCH)
    got = ranks[world][0]
    np.testing.assert_allclose(got["match.cam_pose7"],
                               np.asarray(ref.cam_pose7), atol=POSE_ATOL)
    np.testing.assert_allclose(got["match.points"], np.asarray(ref.points),
                               atol=POINT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_result_replicated_and_inliers_gathered(ranks, single, world):
    """Every rank holds the same result, bit for bit, and obs_inlier comes
    back at the full padded length."""
    first = ranks[world][0]
    for other in ranks[world][1:]:
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    inl = first["match.obs_inlier"]
    O = single.obs_inlier.shape[0]
    assert inl.shape == (-(-O // world) * world,)
    assert not inl[O:].any()
    np.testing.assert_array_equal(inl[:O], tnp(single.obs_inlier))


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_converges(ranks, problems, world):
    _, _, poses_true, _ = problems["converge"]
    et, _ = _pose_errors(jax.numpy.asarray(ranks[world][0]
                                           ["converge.cam_pose7"]),
                         poses_true)
    assert et.max() < 0.02, et.max()


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_entrypoint(ranks, world):
    assert all(bool(r["dryrun_ok"]) for r in ranks[world])


def test_obs_padding(problems):
    cam, prob, *_ = problems["match"]
    cut = prob._replace(**{k: getattr(prob, k)[:1021]
                           for k in ("obs_cam", "obs_point", "obs_uvr",
                                     "obs_inv_sigma2", "obs_valid")})
    padded = dist_ba.pad_problem(_port(cam, cut)[1], 8)
    ref = jdist.pad_problem(cut, 8)
    assert padded.obs_cam.shape[0] % 8 == 0
    assert not padded.obs_valid[1021:].any()
    for k, v in jnp_dict(ref).items():
        np.testing.assert_array_equal(tnp(getattr(padded, k)), v, err_msg=k)
    same = dist_ba.pad_problem(_port(cam, prob)[1], 8)
    assert same.obs_cam.shape[0] == prob.obs_cam.shape[0]


def test_make_mesh_needs_a_started_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        dist_ba.make_mesh()
