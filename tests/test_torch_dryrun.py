"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline.analyze``,
``roofline.report``, ``krr_dist.abstract_dist_inputs``, the kernels' meta
route), on the CPU against the JAX package and against hand counts.

The reference compiles on XLA and reads ``memory_analysis()`` /
``cost_analysis()``; the port traces on meta tensors.  What must agree
exactly: the argument bytes of a compiled step (XLA's
``argument_size_in_bytes``), the extrapolation and model-FLOP arithmetic,
the abstract KRR inputs, and the record keys the report reads.  What the
trace counts is held against hand counts: 2mnk for a product, operand plus
result bytes, the live-bytes peak of a known sequence, and every
collective of one distributed ASkotch step.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import askotch_krr as j_askotch_krr  # noqa: E402
from repro.configs.base import get_reduced_config as j_get_reduced  # noqa: E402
from repro.distributed import krr_dist as j_krr_dist  # noqa: E402
from repro.models.model_api import ShapeConfig as JShapeConfig  # noqa: E402
from repro.roofline import analyze as j_analyze  # noqa: E402
from repro_torch.configs import askotch_krr  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.distributed.krr_dist import DistKRRConfig, abstract_dist_inputs  # noqa: E402
from repro_torch.distributed.meshes import AbstractMesh, SolverMesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model_api import ShapeConfig  # noqa: E402
from repro_torch.roofline import analyze, hw, report  # noqa: E402


def _j_lower_cell():
    """The reference's ``lower_cell``.  Its module sets ``XLA_FLAGS`` at
    import to force 512 host devices; JAX's backend is up first here, and
    the variable comes back as it was, so nothing else sees them."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import lower_cell
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return lower_cell


def test_argument_bytes_equal_xla_at_one_device():
    """Reduced qwen2-1.5b train_small (64 x 8) at (1, 1), built as the
    reference's own dry-run test builds it: parameters, AdamW state, the
    batch and the step counter's 4 bytes."""
    from repro.launch.mesh import make_test_mesh as j_test_mesh

    lower_cell = _j_lower_cell()
    j_shape = JShapeConfig("train_small", "train", 64, 8)
    compiled = lower_cell(j_get_reduced("qwen2-1.5b"), j_shape,
                          j_test_mesh((1, 1), ("data", "model"))).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    cfg = get_reduced_config("qwen2-1.5b")
    got = dryrun.cell_memory(cfg, ShapeConfig("train_small", "train", 64, 8),
                             AbstractMesh(("data", "model"), (1, 1)), None)
    assert got["argument_bytes"] == want
    assert got["alias_bytes"] == got["argument_bytes"] - 4 - 2 * 8 * 64 * 4


@pytest.mark.parametrize("probe", [(10.0, 16.0, 100.0, 130.0), (5.0, 3.0, 7.0, 7.0)])
def test_extrapolate_and_model_flops_equal_reference(probe):
    f1, f2, b1, b2 = probe
    br1, br2 = {"all-reduce": 4.0, "all-gather": 1.0}, {"all-reduce": 6.0}
    args = [(analyze.CellCost(f1, b1, 5.0, br1), analyze.CellCost(f2, b2, 6.0, br2)),
            (j_analyze.CellCost(f1, b1, 5.0, br1), j_analyze.CellCost(f2, b2, 6.0, br2))]
    got = analyze.extrapolate(*args[0], 1, 27)
    want = j_analyze.extrapolate(*args[1], 1, 27)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert analyze.COLLECTIVE_OPS == j_analyze.COLLECTIVE_OPS
    for n, act, tok, train in ((1_543_714_304, 0, 4096 * 256, True),
                               (16_000_000_000, 2_800_000_000, 128, False)):
        assert analyze.model_flops(n, act, tok, train) == j_analyze.model_flops(
            n, act, tok, train)


def test_roofline_terms_at_the_h100_peaks():
    cost = analyze.CellCost(flops=989e12, bytes_accessed=3.35e12 * 2, coll_bytes=50e9 * 0.5,
                            coll_breakdown={"all-reduce": 50e9 * 0.5})
    t = analyze.roofline_terms(cost)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == pytest.approx((1.0, 2.0, 0.5))
    assert t["dominant"] == "memory"
    t32 = analyze.roofline_terms(cost, hw.PEAK_FLOPS_F32)
    assert t32["compute_s"] == pytest.approx(989 / 67) and t32["dominant"] == "compute"
    assert analyze.peak_for("float32") == hw.PEAK_FLOPS_F32 == 67e12
    assert analyze.peak_for("bfloat16") == hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.COLLECTIVE_BW == 50e9 and hw.HBM_BYTES == 80e9
    assert (hw.SINGLE_POD_CHIPS, hw.MULTI_POD_CHIPS) == (256, 512)


def test_trace_cost_hand_counts():
    m, k, n = 64, 32, 16
    a, b = torch.empty(m, k, device="meta"), torch.empty(k, n, device="meta")
    c = analyze.trace_cost(lambda a, b: a @ b, a, b).counter
    assert c.flops == 2 * m * k * n and c.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert c.peak_bytes == 4 * m * n

    def seq(x):  # peak: z and w live with the 4-byte sum
        y = x * 2.0
        z = y + 1.0
        del y
        w = z.exp()
        return w.sum()

    x = torch.empty(100, dtype=torch.float32, device="meta")
    c = analyze.trace_cost(seq, x).counter
    assert c.flops == 4 * 100 and c.bytes_accessed == 3 * 800 + 404
    assert c.peak_bytes == 804 and c.ops == 4
    # views, in-place writes and casts: no allocation, no FLOP for a cast
    c = analyze.trace_cost(lambda x: x.view(10, 10).t().add_(1.0).to(torch.bfloat16), x).counter
    assert c.flops == 100 and c.bytes_accessed == 800 + 400 + 200
    assert c.peak_bytes == 200
    # a repeated op (memoized) counts as the first did
    c = analyze.trace_cost(lambda x: [x * 2.0 for _ in range(3)], x).counter
    assert (c.flops, c.bytes_accessed, c.peak_bytes) == (300, 2400, 1200)


def test_kernels_meta_route_counts_and_launches_nothing():
    ops.reset_launches()
    a, b = torch.empty(50, 9, device="meta"), torch.empty(300, 9, device="meta")
    v = torch.empty(300, 4, device="meta")

    def run():
        return (ops.kernel_matvec(a, b, v), ops.kernel_block(a, b, kernel="laplacian"),
                ops.kernel_matvec_multi(a, b, v, kernels=("rbf", "matern52"), sigmas=(1, 2),
                                        weights=(0.5, 0.5)),
                ops.kernel_matvec_components(a, b, v, kernels=("rbf", "linear"), sigmas=(1, 1)),
                ops.kernel_block_multi(a, b, kernels=("rbf",), sigmas=(1,), weights=(1.0,)))

    tr = analyze.trace_cost(run)
    shapes = [tuple(o.shape) for o in tr.out]
    assert shapes == [(50, 4), (50, 300), (50, 4), (2, 50, 4), (50, 300)]
    assert all(o.device.type == "meta" and o.dtype == torch.float32 for o in tr.out)
    want = [analyze.kernel_cost(50, 300, 9, 4), analyze.kernel_cost(50, 300, 9, None, "laplacian"),
            analyze.multi_kernel_cost(50, 300, 9, 4, ("rbf", "matern52"), "matvec"),
            analyze.multi_kernel_cost(50, 300, 9, 4, ("rbf", "linear"), "components"),
            analyze.multi_kernel_cost(50, 300, 9, 0, ("rbf",), "block")]
    assert tr.counter.kernels == {k: 1 for k in ops.launches()}
    assert tr.counter.flops == sum(f for f, _ in want)
    assert tr.counter.bytes_accessed == sum(nb for _, nb in want)
    assert analyze.rbf_ops_per_pair(9, 1) == 2 * 9 + 3 + 2 + 2
    assert set(ops.launches().values()) == {0}


def test_abstract_dist_inputs_match_reference():
    k, jk = askotch_krr.config(), j_askotch_krr.config()
    assert dataclasses.asdict(k) == dataclasses.asdict(jk)
    assert dataclasses.asdict(askotch_krr.reduced()) == dataclasses.asdict(j_askotch_krr.reduced())
    for heads in (1, 3):
        cfg = DistKRRConfig(n=4096, d=9, block_size=256, rank=32, heads=heads)
        jcfg = j_krr_dist.DistKRRConfig(n=4096, d=9, block_size=256, rank=32, heads=heads)
        (state, x, y), (jstate, jx, jy) = abstract_dist_inputs(cfg), \
            j_krr_dist.abstract_dist_inputs(jcfg)
        got = [state.w, state.v, state.z, state.generator, state.sketch_res, state.pv, x, y]
        want = [jstate.w, jstate.v, jstate.z, jstate.key, jstate.sketch_res, jstate.pv, jx, jy]
        for g, w in zip(got, want):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_krr_cell_collectives_equal_a_hand_count():
    """One step at ``askotch_krr.reduced()`` on a (2, 4) mesh of meta
    devices: per device, the packed row gather (b x (d + 2)), the two
    r x r Nystrom Grams, per powering iteration two r-vectors (the
    inverse square roots) and a 2-vector (the Rayleigh stats) summed and two
    b/M slices gathered, the G_B partial (b/M) summed over rows, the
    Woodbury r-vector summed and the [D | G] block (b/M x 2) gathered."""
    kcfg = askotch_krr.reduced()
    dcfg = dryrun.krr_dist_config(kcfg)
    mesh = SolverMesh(["meta"] * 8, shape=(2, 4))
    rec = dryrun.krr_cell(dcfg, mesh)
    b, d, r, m, it, f4 = kcfg.block_size, kcfg.d, kcfg.rank, 4, 10, 4
    reduce_ = f4 * (b * (d + 2) + 2 * r * r + it * (2 * r + 2) + b // m + r)
    gather = f4 * (it * 2 * (b // m) + (b // m) * 2)
    cost = rec["cost_extrapolated"]
    assert cost["coll_breakdown"]["all-reduce"] == reduce_
    assert cost["coll_breakdown"]["all-gather"] == gather
    assert cost["coll_bytes"] == reduce_ + gather
    assert cost["flops"] == dryrun.krr_analytic_flops(dcfg) / 8
    # per device: the G_B matvec, the sketch matvec and one a powering iteration
    assert rec["kernel_calls"] == {"kernel_matvec": 8 * (2 + it)}
    n_loc = kcfg.n // 2
    assert rec["memory"]["argument_bytes"] == f4 * (4 * n_loc + n_loc * d + 1 + b) + 8
    assert rec["memory"]["alias_bytes"] == rec["memory"]["output_bytes"] == f4 * (
        3 * n_loc + 1 + b) + 8


def test_run_cell_keys_and_report(tmp_path):
    """The CLI on one LM shape and the KRR cell (reduced: a KRR cell at
    full size takes ~7 s): the reference's record keys, and both tables."""
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k,long_500k", "--mesh", "both",
                 "--out", str(tmp_path)])
    recs = report.load(str(tmp_path))
    assert len(recs) == 4 and os.path.exists(tmp_path / "qwen2-1.5b__decode_32k__single.json")
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert len(ok) == 2 and len(skipped) == 2 and "reason" in skipped[0]
    for r in ok:
        assert {"arch", "shape", "mesh", "status", "memory", "n_params", "n_active_params",
                "cost_raw", "cost_extrapolated", "probe_raw", "tokens", "model_flops_total",
                "seconds"} <= set(r)
        assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"} <= set(r["memory"])
        assert r["cost_extrapolated"]["coll_bytes"] is None
        assert r["tokens"] == 128
    single, multi = (next(r for r in ok if r["mesh"] == m) for m in ("single", "multi"))
    assert single["cost_extrapolated"]["flops"] == 2 * multi["cost_extrapolated"]["flops"]
    mesh = SolverMesh(["meta"] * 8, shape=(2, 4))
    krr = dict(arch=dryrun.KRR_ARCH, shape="krr_step", mesh="single", status="ok",
               **dryrun.krr_cell(dryrun.krr_dist_config(askotch_krr.reduced()), mesh))
    with open(tmp_path / "krr.json", "w") as f:
        json.dump(krr, f)
    recs = report.load(str(tmp_path))
    single_t, multi_t = report.dryrun_table(recs, "single"), report.dryrun_table(recs, "multi")
    assert "fits 80 GB" in single_t and "| qwen2-1.5b | decode_32k | ok |" in multi_t
    assert "all-reduce:" in single_t and "not counted" in single_t
    roof = report.roofline_table(recs)
    assert f"| {dryrun.KRR_ARCH} | krr_step |" in roof and "| qwen2-1.5b | decode_32k |" in roof
    line = next(x for x in roof.splitlines() if x.startswith(f"| {dryrun.KRR_ARCH}"))
    assert float(line.split("|")[3]) == pytest.approx(
        krr["cost_extrapolated"]["flops"] / hw.PEAK_FLOPS_F32, abs=1e-4)
    np.testing.assert_allclose(
        single["model_flops_total"], 2.0 * single["n_params"] * 128)
