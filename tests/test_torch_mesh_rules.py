"""The port's logical-axis rules, device-free meshes and elastic checkpoint
restore (``repro_torch.distributed.meshes``, ``launch.mesh``,
``checkpoint.checkpointer.restore(shardings=)``), on the CPU against the
JAX package.

The physical specs and per-device shard shapes of every leaf of all ten
published configs — parameters, optimizer state, caches and batches at the
four shapes — are held against the reference's ``to_physical`` /
``sanitize_pspec`` and ``NamedSharding(AbstractMesh(...)).shard_shape`` on
the production meshes and a single-axis mesh.  The reference's rules read
only ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in holding
an empty array of the mesh's shape serves them without 512 devices.
``PartitionSpec`` writes a one-name tuple as the name, so specs are
compared in that form.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as JC  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.distributed import meshes as JM  # noqa: E402
from repro.models import model_api as j_api  # noqa: E402
from repro.training.optimizers import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.checkpoint import checkpointer as TC  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import meshes as TM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.models.model_api import ALL_SHAPES, flatten  # noqa: E402
from repro_torch.roofline import analyze  # noqa: E402

MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((8,), ("rows",)))


class _StandIn:
    """What the reference's rules read of a mesh: axis names and a devices
    array of the mesh's shape."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def _norm(spec) -> tuple:
    """A spec as ``PartitionSpec`` holds it: a one-name tuple is the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _j_rules(j_cfg, mesh):
    rules = JM.default_rules(mesh)
    if j_cfg.fsdp_over_pod and "pod" in mesh.axis_names:
        rules = dict(rules, fsdp=("pod", "data"))
    return rules


def _trees(arch):
    """(port specs, port structs, reference specs, reference structs) of
    every leaf, by dotted path: parameters, optimizer state, and each
    shape's batch and cache."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    impl, j_impl = model_api.get_model(cfg), j_api.get_model(j_cfg)
    params, j_params = model_api.abstract_params(cfg), j_api.abstract_params(j_cfg)
    pspecs, j_pspecs = model_api.param_pspecs(cfg), j_api.param_pspecs(j_cfg)
    opt, j_opt = dryrun._optimizer(cfg), j_make_optimizer(j_cfg.optimizer, 3e-4)
    specs = {"params": pspecs, "opt": opt.state_specs(pspecs, params)}
    structs = {"params": params, "opt": opt.init(params)}
    j_specs = {"params": j_pspecs, "opt": j_opt.state_specs(j_pspecs, j_params)}
    j_structs = {"params": j_params, "opt": jax.eval_shape(j_opt.init, j_params)}
    for shape in ALL_SHAPES:
        b, s = shape.global_batch, shape.seq_len
        binputs, j_binputs = impl.input_specs(cfg, shape), j_impl.input_specs(j_cfg, shape)
        specs[shape.name] = {"batch": dryrun._batch_pspecs(binputs),
                             "cache": impl.cache_specs(cfg, b, s)}
        structs[shape.name] = {"batch": binputs,
                               "cache": impl.init_cache(cfg, b, s, abstract=True)}
        j_specs[shape.name] = {
            "batch": {k: P("dp", None, None) if v.ndim == 3 else P("dp", None)
                      for k, v in j_binputs.items()},
            "cache": j_impl.cache_specs(j_cfg, b, s)}
        j_structs[shape.name] = {"batch": j_binputs,
                                 "cache": j_impl.init_cache(j_cfg, b, s, abstract=True)}
    return cfg, j_cfg, flatten(specs), flatten(structs), flatten(j_specs), flatten(j_structs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_shard_shapes_match_reference(arch):
    cfg, j_cfg, specs, structs, j_specs, j_structs = _trees(arch)
    assert set(specs) == set(j_specs) == set(structs) == set(j_structs)
    for shape, axes in MESHES:
        mesh, j_mesh = TM.AbstractMesh(axes, shape), _StandIn(shape, axes)
        j_abstract = JAbstractMesh(shape, axes)
        rules, j_rules = dryrun._rules_for(cfg, mesh), _j_rules(j_cfg, j_mesh)
        assert {k: _norm(v) if isinstance(v, tuple) else v for k, v in rules.items()} == {
            k: _norm(v) if isinstance(v, tuple) else v for k, v in j_rules.items()}
        for path, spec in specs.items():
            dims = tuple(structs[path].shape)
            assert dims == tuple(j_structs[path].shape), path
            phys = TM.sanitize_pspec(TM.to_physical(spec, rules), dims, mesh)
            j_phys = JM.sanitize_pspec(JM.to_physical(j_specs[path], j_rules), dims, j_mesh)
            assert _norm(phys) == tuple(j_phys), (shape, path, phys, j_phys)
            assert mesh.shard_shape(phys, dims) == tuple(
                NamedSharding(j_abstract, j_phys).shard_shape(dims)), (shape, path)


def test_logical_rules_nest_and_restore():
    outer, inner = {"dp": ("data",), "tp": "model"}, {"dp": ("pod", "data"), "tp": None}
    assert TM.current_rules() is None
    assert TM.to_physical(("dp", "tp")) == ("dp", "tp")  # no rules: unchanged
    with TM.logical_rules(outer):
        assert TM.to_physical(("dp", None, "tp")) == (("data",), None, "model")
        with TM.logical_rules(inner):
            assert TM.current_rules() is inner
            assert TM.to_physical(("dp", "tp", ("fsdp", "tp"))) == (
                ("pod", "data"), None, ("fsdp",))
        assert TM.current_rules() is outer
        x = torch.ones(2)
        assert TM.logical_constraint(x, ("dp",)) is x
    assert TM.current_rules() is None
    with pytest.raises(RuntimeError), TM.logical_rules(outer):
        raise RuntimeError("left by an error")
    assert TM.current_rules() is None
    tree = {"a": ("dp", None), "b": {"c": ("tp",)}}
    assert TM.tree_to_physical(tree, outer) == {"a": (("data",), None), "b": {"c": ("model",)}}


def test_meshes_and_sharding_pairs():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert isinstance(make_test_mesh((2, 4)), TM.AbstractMesh)
    solver = make_test_mesh((2, 2), devices=["cpu"] * 4)
    assert isinstance(solver, TM.SolverMesh) and solver.size == 4
    with pytest.raises(ValueError, match="axes"):
        make_test_mesh((4,), ("rows",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        single.shard_shape(("data",), (24,))
    with pytest.raises(ValueError, match="no axis"):
        single.shard_shape(("pod",), (32,))
    specs = {"w": ("fsdp", "tp"), "b": ("tp",)}
    structs = {"w": torch.empty(64, 30, device="meta"), "b": torch.empty(30, device="meta")}
    assert TM.named_shardings(single, specs) == {"w": (single, ("data", "model")),
                                                  "b": (single, ("model",))}
    assert TM.sanitized_shardings(single, specs, structs) == {
        "w": (single, ("data", None)), "b": (single, (None,))}
    assert solver.shard_shape(("data", "model"), (6, 8)) == (3, 4)


def test_solver_mesh_collectives_record_operand_bytes():
    mesh = TM.SolverMesh(["cpu"] * 4, shape=(2, 2))
    parts = mesh.each(lambda c: torch.full((3, 5), float(c[0] + 2 * c[1])))

    def run():
        g = mesh.all_gather(parts, "data")
        s = mesh.psum(parts, "model")
        TM.SolverMesh(["cpu"], shape=(1, 1)).psum({(0, 0): parts[(0, 0)]}, "data")
        return g, s

    tr = analyze.trace_cost(run)
    assert tr.counter.coll_breakdown == {"all-gather": 60.0, "all-reduce": 60.0}
    g, s = tr.out
    assert torch.equal(g[(1, 1)], torch.cat([parts[(0, 1)], parts[(1, 1)]]))
    assert torch.equal(s[(0, 1)], parts[(0, 0)] + parts[(0, 1)])


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    mesh4 = TM.SolverMesh(["cpu"] * 4, shape=(4, 1))
    mesh2 = TM.SolverMesh(["cpu"] * 2, shape=(2, 1))
    w = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    bias = torch.linspace(0.0, 1.0, 12).to(torch.bfloat16)
    saved = mesh4.shard(w, ("data", None))
    assert {c: tuple(t.shape) for c, t in saved.items()} == {(i, 0): (2, 12) for i in range(4)}
    TC.save(str(tmp_path), 3, {"params": {"w": saved, "b": bias}})
    state, _, step = TC.restore(str(tmp_path), shardings={
        "params": {"w": (mesh2, ("data", None)), "b": (mesh2, (None,))}})
    got = state["params"]["w"]
    assert step == 3 and isinstance(got, TM.ShardedValue)
    assert len({id(t) for t in got.values()}) == 2
    assert torch.equal(torch.cat([got[(0, 0)], got[(1, 0)]]), w)
    assert torch.equal(got.global_array(), w)
    assert state["params"]["b"][(1, 0)].dtype == torch.bfloat16
    assert torch.equal(state["params"]["b"][(1, 0)], bias)
    # the reference's own save of the same array reads back the same
    plain, _, _ = TC.restore(str(tmp_path), device="cpu")
    assert torch.equal(plain["params"]["w"], w)


def test_reference_checkpoint_restores_onto_a_mesh(tmp_path):
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    JC.save(str(tmp_path), 7, {"params": {"w": w}, "opt_state": ({"m": w * 2},)})
    mesh = TM.SolverMesh(["cpu"] * 4, shape=(2, 2))
    state, _, step = TC.restore(str(tmp_path), shardings={
        "params": {"w": (mesh, ("data", "model"))},
        "opt_state": ({"m": (mesh, (None, "model"))},)})
    got = state["params"]["w"]
    assert step == 7 and got[(1, 0)].shape == (2, 3)
    assert np.array_equal(got[(1, 0)].numpy(), w[2:, :3])
    assert np.array_equal(got.global_array().numpy(), w)
    assert np.array_equal(state["opt_state"][0]["m"][(0, 1)].numpy(), (w * 2)[:, 3:])
    # and the port writes a sharded leaf that the reference reads back whole
    TC.save(str(tmp_path / "port"), 1, {"w": got})
    back, _, _ = JC.restore(str(tmp_path / "port"))
    assert np.array_equal(back["w"], w)
    assert os.path.isdir(tmp_path / "port" / "step_00000001")
