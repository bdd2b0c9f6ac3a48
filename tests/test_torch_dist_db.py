"""The port's keyframe-sharded BoW query (`parallel/dist_db.py`) on 2 and 4
gloo ranks on the CPU, against the single query of both packages and the
reference's sharded query on its virtual CPU mesh: the twins of
tests/test_dist_db.py:26-55. The ranks run once per world size, in spawned
processes (tests/_torch_dist.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import _torch_dist
from orb_slam2_e_tpu.models import kf_database as jkdb
from orb_slam2_e_tpu.parallel import dist_ba as jdist_ba
from orb_slam2_e_tpu.parallel import dist_db as jdist_db
from orb_slam2_e_tpu_torch.models import kf_database as tkdb
from orb_slam2_e_tpu_torch.parallel import dist_db
from test_dist_db import _mk

WORLDS = [2, 4]
N = 5
SCORE_ATOL = 1e-6


def _cases():
    """{case: (vecs, filled, q, n, exclude or None)} as numpy: the plain
    query (seed 3), and the exclusion of the single query's winner (seed
    4), at K = 48 and at K = 45, which the padding has to even out."""
    out = {}
    for K in (48, 45):
        vecs, filled, q = (np.array(x) for x in _mk(seed=3))
        out[f"plain{K}"] = (vecs[:K], filled[:K], q, N, None)
        vecs, filled, q = (np.array(x) for x in _mk(seed=4))
        db = jkdb.BowDatabase(vecs=jnp.asarray(vecs[:K]),
                              filled=jnp.asarray(filled[:K]))
        win, _ = jkdb.detect_relocalization_candidates(db, jnp.asarray(q), 1)
        excl = np.zeros(K, bool)
        excl[int(win[0])] = True
        out[f"exclude{K}"] = (vecs[:K], filled[:K], q, N, excl)
    return out


CASES = sorted(_cases())


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_db")
    arrays = {}
    for case, (vecs, filled, q, n, excl) in cases.items():
        arrays.update({f"{case}.vecs": vecs, f"{case}.filled": filled,
                       f"{case}.q": q, f"{case}.n": np.asarray(n)})
        if excl is not None:
            arrays[f"{case}.exclude"] = excl
    np.savez(root / "inputs.npz", **arrays)
    return _torch_dist.spawn(_torch_dist.rank_db, WORLDS,
                             root / "inputs.npz", root)


def _single_reference(vecs, filled, q, n, excl):
    """The reference's single-device query, the excluded slots scored -1
    as its sharded query does."""
    if excl is not None:
        filled = filled & ~excl
    db = jkdb.BowDatabase(vecs=jnp.asarray(vecs), filled=jnp.asarray(filled))
    slots, scores = jkdb.detect_relocalization_candidates(
        db, jnp.asarray(q), n)
    return np.asarray(slots), np.asarray(scores)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_query_matches_single(ranks, cases, case, world):
    """Slots and scores of the single query, in its order (ties: lower
    slot first), on every rank; the port's single query agrees too."""
    vecs, filled, q, n, excl = cases[case]
    ref_i, ref_s = _single_reference(vecs, filled, q, n, excl)
    f = filled if excl is None else filled & ~excl
    port_i, port_s = tkdb.detect_relocalization_candidates(
        tkdb.BowDatabase(vecs=torch.from_numpy(vecs),
                         filled=torch.from_numpy(f)), torch.from_numpy(q), n)
    np.testing.assert_array_equal(port_i.numpy(), ref_i)
    for got in ranks[world]:
        np.testing.assert_array_equal(got[f"{case}.slots"], ref_i)
        np.testing.assert_allclose(got[f"{case}.scores"], ref_s,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(got[f"{case}.scores"], port_s.numpy(),
                                   atol=SCORE_ATOL)
    if excl is not None:
        assert not excl[got[f"{case}.slots"]].any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["plain45", "exclude45"])
def test_sharded_query_matches_reference_sharded(ranks, cases, case, world):
    """The reference's sharded query over its mesh of `world` virtual
    devices (fewer where the conftest's flag did not take), on the cases
    that need padding (each compiles the reference's shard_map anew)."""
    vecs, filled, q, n, excl = cases[case]
    n_dev = min(world, len(jax.devices()))
    mesh = jdist_ba.make_mesh(n_dev, axis="kf")
    pv, pf = jdist_db.pad_rows(jnp.asarray(vecs), jnp.asarray(filled), n_dev)
    pe = None
    if excl is not None:
        pe = jnp.concatenate([jnp.asarray(excl),
                              jnp.zeros(pv.shape[0] - len(excl), bool)])
    ref_i, ref_s = jdist_db.sharded_query(mesh, pv, pf, jnp.asarray(q), n,
                                          exclude_mask=pe)
    got = ranks[world][0]
    np.testing.assert_array_equal(got[f"{case}.slots"], np.asarray(ref_i))
    np.testing.assert_allclose(got[f"{case}.scores"], np.asarray(ref_s),
                               atol=SCORE_ATOL)


def test_pad_rows():
    vecs, filled, _ = (np.array(x) for x in _mk())
    pv, pf = dist_db.pad_rows(torch.from_numpy(vecs[:45]),
                              torch.from_numpy(filled[:45]), 4)
    rv, rf = jdist_db.pad_rows(jnp.asarray(vecs[:45]),
                               jnp.asarray(filled[:45]), 4)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    assert pv.shape[0] == 48 and not pf[45:].any()
