"""The port's divide-and-conquer tier (``repro_torch.distributed.partition``
/ ``dc``, ``solve(method="dc")``) held against the JAX package.

Inputs are made with numpy from a seed (n <= 257, d <= 4) and cross as
numpy arrays or as a ``Partition``'s JSON.  JAX runs on its own single CPU
device (a (1, 1) ``make_solver_mesh`` where a mesh is needed; no XLA flag
is set); the port runs on CPU tensors and on ``SolverMesh``es of ``cpu``
devices.  Tolerances are the kernel tests': f32 rtol 2e-4, atol 2e-5 x
max(1, |ref|max).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.solver_api import DC_METHOD_OPTIONS as J_DC_OPTIONS  # noqa: E402
from repro.distributed import dc as j_dc  # noqa: E402
from repro.distributed import partition as j_part  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402
from repro_torch.core.solver_api import DC_METHOD_OPTIONS, METHODS, solve  # noqa: E402
from repro_torch.distributed import dc, partition  # noqa: E402
from repro_torch.distributed.meshes import SolverMesh, make_solver_mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

N, D, SIGMA, LAM = 240, 4, 1.5, 1e-3


def _close(got, want, rtol=2e-4, atol=2e-5):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _data(n=N, d=D, t=None, seed=0, n_test=40):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n + n_test, d)).astype(np.float32)
    y = r.standard_normal((n,) if t is None else (n, t)).astype(np.float32)
    return x[:n], y, x[n:]


def _problem(x, y, **kw):
    return KRRProblem(x=torch.from_numpy(x), y=torch.from_numpy(y), sigma=SIGMA,
                      lam_unscaled=LAM, **kw)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", partition.PARTITION_KINDS)
def test_partition_equals_reference_and_round_trips(kind):
    x = np.random.default_rng(7).standard_normal((257, 3)).astype(np.float32)
    mine = partition.make_partition(x, 4, kind=kind, seed=3)
    ref = j_part.make_partition(x, 4, kind=kind, seed=3)
    np.testing.assert_array_equal(mine.assignments, ref.assignments)
    np.testing.assert_allclose(mine.centers, ref.centers, rtol=0, atol=1e-6)
    again = partition.make_partition(torch.from_numpy(x), 4, kind=kind, seed=3)
    np.testing.assert_array_equal(again.assignments, mine.assignments)  # deterministic
    np.testing.assert_array_equal(np.sort(mine.sizes), np.sort(partition.balanced_sizes(257, 4)))
    assert not np.array_equal(
        partition.make_partition(x, 4, kind=kind, seed=4).assignments, mine.assignments)
    idx = mine.shard_indices()
    np.testing.assert_array_equal(np.sort(np.concatenate(idx)), np.arange(257))
    # the JSON both packages read, each way
    back = partition.Partition.from_json(ref.to_json())
    np.testing.assert_array_equal(back.assignments, ref.assignments)
    np.testing.assert_array_equal(back.centers, ref.centers)
    assert (back.kind, back.seed) == (ref.kind, ref.seed)
    there = j_part.Partition.from_json(mine.to_json())
    np.testing.assert_array_equal(there.assignments, mine.assignments)
    np.testing.assert_array_equal(there.centers, mine.centers)
    assert json.loads(mine.to_json()).keys() == json.loads(ref.to_json()).keys()
    assert convert.partition_from_reference(ref).to_json() == ref.to_json()
    # k = 1 is the identity
    np.testing.assert_array_equal(
        partition.make_partition(x, 1, kind=kind).shard_indices()[0], np.arange(257))


def test_partition_validation_matches_reference():
    x = np.zeros((10, 2), np.float32)
    for mine, ref in ((lambda: partition.random_partition(x, 0),
                       lambda: j_part.random_partition(x, 0)),
                      (lambda: partition.random_partition(x, 11),
                       lambda: j_part.random_partition(x, 11)),
                      (lambda: partition.make_partition(x, 2, kind="voronoi"),
                       lambda: j_part.make_partition(x, 2, kind="voronoi")),
                      (lambda: partition.Partition(np.array([0, 3]), np.zeros((2, 2)), "random", 0),
                       lambda: j_part.Partition(np.array([0, 3]), np.zeros((2, 2)), "random", 0))):
        with pytest.raises(ValueError) as e_mine:
            mine()
        with pytest.raises(ValueError) as e_ref:
            ref()
        assert str(e_mine.value) == str(e_ref.value)


# ---------------------------------------------------------------------------
# combiners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combiner", dc.COMBINERS)
def test_combiner_weights_match_reference(combiner):
    x = np.random.default_rng(3).standard_normal((90, 4)).astype(np.float32)
    part = partition.kmeans_partition(x, 3, seed=0)
    xq = np.random.default_rng(4).standard_normal((17, 4)).astype(np.float32)
    w = dc.combiner_weights(part, torch.from_numpy(xq), combiner)
    assert w.shape == (17, 3) and np.all(w >= 0)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-6)
    ref = j_dc.combiner_weights(j_part.Partition.from_json(part.to_json()), xq, combiner)
    np.testing.assert_allclose(w, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown combiner"):
        dc.combiner_weights(part, xq, "median")


# ---------------------------------------------------------------------------
# solve(method="dc")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combiner", dc.COMBINERS)
def test_dc_direct_matches_reference_with_a_shared_partition(combiner):
    """The reference's partition (through its JSON) and a deterministic
    inner solve: the scattered w and the combined predictions agree, and
    the reference's DC model carried across predicts the same."""
    x, y, xt = _data()
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), sigma=SIGMA, lam_unscaled=LAM)
    jpart = j_part.kmeans_partition(x, 3, seed=1)
    jres = j_dc.solve_dc(jp, partition=jpart, combiner=combiner, method="direct")
    res = dc.solve_dc(_problem(x, y), partition=partition.Partition.from_json(jpart.to_json()),
                      combiner=combiner, method="direct")
    want = np.asarray(jres.predict_fn(jnp.asarray(xt)))
    _close(res.w, jres.w)
    _close(res.predict_fn(torch.from_numpy(xt)), want)
    _, w_c, predict_c = convert.dc_from_reference(
        x, jpart, [np.asarray(o.w) for o in jres.shard_outputs], sigma=SIGMA,
        combiner=combiner, device="cpu")
    _close(w_c, jres.w)
    _close(predict_c(xt), want)
    assert res.info["collective_dispatches"] == 0
    assert res.history[-1]["shard"] is None and len(res.history) == 4


def test_dc_k1_is_bitwise_the_plain_solve():
    x, y, xt = _data()
    p = _problem(x, y)
    base = solve(p, "pcg-nystrom", max_iters=60, tol=1e-7, seed=0, rank=40)
    out = solve(p, "dc", dc_shards=1, dc_method="pcg-nystrom", max_iters=60, tol=1e-7,
                seed=0, rank=40)
    assert torch.equal(base.w, out.w)
    assert torch.equal(base.predict_fn(torch.from_numpy(xt)), out.predict_fn(torch.from_numpy(xt)))


def test_dc_meshes_are_bitwise_the_sequential_run_with_zero_collectives():
    x, y, xt = _data()
    p = _problem(x, y)
    kw = dict(dc_shards=3, dc_method="askotch", block_size=40, rank=16, max_iters=20, seed=0)
    before = obs_metrics.snapshot()
    seq = solve(p, "dc", **kw)
    assert dc.collective_dispatch_delta(before, obs_metrics.snapshot()) == 0.0
    assert seq.info["collective_dispatches"] == 0 and seq.info["mesh"] is None
    q = torch.from_numpy(xt)
    for mesh in (make_solver_mesh("1x1", device="cpu"), SolverMesh(["cpu"] * 2, shape=(2, 1))):
        par = solve(p, "dc", mesh=mesh, **kw)
        assert torch.equal(seq.w, par.w)
        assert torch.equal(seq.predict_fn(q), par.predict_fn(q))
        assert par.info["mesh"] == mesh.shape and par.info["collective_dispatches"] == 0
    assert seq.info["per_shard_iters"] == [20, 20, 20]


def test_dc_multirhs_and_multikernel_ride_through():
    x, y, xt = _data(n=150, t=3, seed=5)
    p = _problem(x, y)
    out = solve(p, "dc", dc_shards=2, dc_method="pcg-nystrom", max_iters=40,
                kernel=("rbf", "laplacian"), weights=(0.7, 0.3), seed=0)
    assert out.w.shape == (150, 3)
    pred = out.predict_fn(torch.from_numpy(xt))
    assert pred.shape == (40, 3) and bool(torch.isfinite(pred).all())
    fk = solve(p, "dc", dc_shards=2, dc_method="falkon", m=20, max_iters=10, seed=0)
    assert fk.w is None and fk.predict_fn(torch.from_numpy(xt)).shape == (40, 3)


def test_dc_option_validation_matches_reference():
    x, y, _ = _data(n=60)
    p = _problem(x, y)
    assert "dc" in METHODS and DC_METHOD_OPTIONS == J_DC_OPTIONS
    with pytest.raises(ValueError, match="inner solver"):
        solve(p, "dc", dc_method="dc")
    with pytest.raises(ValueError, match="dc_bogus"):
        solve(p, "dc", dc_bogus=1)
    with pytest.raises(ValueError, match="unknown option"):
        solve(p, "dc", dc_shards=2, dc_method="direct", max_iters=5)
    with pytest.raises(ValueError, match="combiner"):
        solve(p, "dc", dc_combiner="median")
    with pytest.raises(ValueError, match="partition"):
        solve(p, "dc", dc_partition="voronoi")
    with pytest.raises(ValueError, match="precomputed"):
        gp = KRRProblem(x=torch.eye(16), y=torch.zeros(16), kernel="precomputed")
        solve(gp, "dc", dc_shards=2)
    part = partition.random_partition(np.zeros((10, 2), np.float32), 2)
    with pytest.raises(ValueError, match="covers 10 rows"):
        dc.solve_dc(p, partition=part, method="direct")
