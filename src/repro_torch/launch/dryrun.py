"""Multi-pod dry run: trace every (arch x input-shape x mesh) cell on meta
tensors — the port of ``repro.launch.dryrun``.

For each cell this writes one JSON under ``--out`` (resumable; one file per
cell) with the reference's keys: the per-device memory figures, the
per-device cost (FLOPs, bytes accessed, collective bytes) and the model
FLOPs.  Every figure is a prediction for H100s on the production meshes
(``launch/mesh.py``: 16 x 16 or 2 x 16 x 16), made without a card: the
step runs on ``meta`` tensors under ``roofline.analyze.trace_cost``.

  * ``memory.argument_bytes`` / ``output_bytes`` / ``alias_bytes`` are exact
    per device: the shard shapes of the sanitized physical specs (the
    logical-axis rules of ``distributed.meshes``) of the step's arguments
    and outputs; the donated parameters and optimizer state (train) and the
    donated cache (decode) alias their outputs.  Outputs the reference
    leaves to XLA (``out_shardings=None``: logits, the train metrics) are
    laid out as the batch, or replicated.
  * ``memory.temp_bytes`` is the trace's peak live bytes beyond the
    arguments over the device count: the perfect-sharding figure.  The
    peak comes from traces at 1 and 2 units with the arch's own remat,
    attention chunks, MoE rounds and microbatches, extrapolated to full
    depth.
  * LM cost: a whole-depth trace of a deep or scanned model is slow, so each
    (arch, shape) is traced once at 1 and 2 units (``_probe_cfg``: one
    microbatch, unchunked attention and MoE dispatch, no remat, as the
    reference's probes) and extrapolated to full depth; the global counts
    are divided by the device count, as the reference does for its KRR
    FLOPs.  Only the spec-derived figures and the division change per
    mesh.  ``coll_bytes`` is null: the port has no sharded LM program.
  * The KRR cell traces one distributed ASkotch step on a ``SolverMesh``
    of meta devices — (16, 16), or (32, 16) with rows over ("pod",
    "data") — with its draws injected; its collectives are the mesh's
    counted operand bytes and its FLOPs the reference's analytic count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh both --out results/dryrun_torch [--skip-existing]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import askotch_krr
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.distributed.krr_dist import (
    DistKRRConfig,
    abstract_dist_inputs,
    make_dist_askotch_step,
)
from repro_torch.distributed.meshes import SolverMesh, default_rules, sanitized_shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_api import (
    ALL_SHAPES,
    SHAPES_BY_NAME,
    abstract_params,
    flatten,
    get_model,
    param_pspecs,
    shape_applicable,
)
from repro_torch.roofline import analyze
from repro_torch.training.optimizers import make_optimizer
from repro_torch.training.schedules import warmup_cosine
from repro_torch.training.train_step import make_train_step

KRR_ARCH = "askotch-krr-taxi-100m"
TEMP_BASIS = ("perfect sharding: the trace's peak live bytes beyond the arguments "
              "over the device count")
NO_LM_COLLECTIVES = "null: the port has no sharded LM program whose collectives it could count"
#: the train metrics (loss, grad_norm, lr): replicated f32 scalars
TRAIN_METRICS_BYTES = 3 * 4
STEP_BYTES = 4  # the int32 step counter


def _batch_pspecs(binputs: dict) -> dict:
    return {name: ("dp", None, None) if s.ndim == 3 else ("dp", None)
            for name, s in binputs.items()}


def _rules_for(cfg, mesh):
    rules = default_rules(mesh)
    if getattr(cfg, "fsdp_over_pod", False) and "pod" in mesh.axis_names:
        rules = dict(rules)
        rules["fsdp"] = ("pod", "data")
    return rules


def _optimizer(cfg):
    return make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 2000, 100_000))


def _meta_step() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device="meta")


def _shard_bytes(shardings, structs) -> int:
    """Per-device bytes of a tree of tensors under a tree of (mesh, spec)
    pairs (or of one tensor under one pair)."""
    if not isinstance(structs, dict):
        shardings, structs = {"": shardings}, {"": structs}
    sh = flatten(shardings)
    total = 0
    for k, t in flatten(structs).items():
        mesh, spec = sh[k]
        total += math.prod(mesh.shard_shape(spec, t.shape)) * t.element_size()
    return total


def trace_cell(cfg, shape) -> analyze.Trace:
    """One (arch x shape) step on meta tensors, counted: the train step
    (the arch's optimizer under ``warmup_cosine(3e-4, 2000, 100_000)``),
    ``prefill`` or ``decode_step`` on ``abstract_params`` and
    ``input_specs``."""
    impl = get_model(cfg)
    params = abstract_params(cfg)
    batch = impl.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = _optimizer(cfg)
        return analyze.trace_cost(make_train_step(cfg, opt), params, opt.init(params), batch,
                                  _meta_step())
    if shape.kind == "prefill":
        return analyze.trace_cost(impl.prefill, params, batch, cfg)
    cache = impl.init_cache(cfg, shape.global_batch, shape.seq_len, abstract=True)
    return analyze.trace_cost(impl.decode_step, params, cache, batch, cfg)


def cell_memory(cfg, shape, mesh, logits: torch.Tensor | None) -> dict:
    """Exact per-device argument, output and alias bytes of a cell on
    ``mesh`` (``temp_bytes`` is the caller's)."""
    impl = get_model(cfg)
    rules = _rules_for(cfg, mesh)
    params = abstract_params(cfg)
    pspecs = param_pspecs(cfg)
    p_bytes = _shard_bytes(sanitized_shardings(mesh, pspecs, params, rules), params)
    binputs = impl.input_specs(cfg, shape)
    b_bytes = _shard_bytes(sanitized_shardings(mesh, _batch_pspecs(binputs), binputs, rules),
                           binputs)
    if shape.kind == "train":
        opt = _optimizer(cfg)
        opt_state = opt.init(params)
        o_bytes = _shard_bytes(sanitized_shardings(
            mesh, opt.state_specs(pspecs, params), opt_state, rules), opt_state)
        return {"argument_bytes": p_bytes + o_bytes + b_bytes + STEP_BYTES,
                "output_bytes": p_bytes + o_bytes + TRAIN_METRICS_BYTES,
                "alias_bytes": p_bytes + o_bytes}
    cache = impl.init_cache(cfg, shape.global_batch, shape.seq_len, abstract=True)
    c_bytes = _shard_bytes(sanitized_shardings(
        mesh, impl.cache_specs(cfg, shape.global_batch, shape.seq_len), cache, rules), cache)
    l_bytes = _shard_bytes(sanitized_shardings(
        mesh, ("dp",) + (None,) * (logits.ndim - 1), logits, rules), logits)
    if shape.kind == "prefill":
        return {"argument_bytes": p_bytes + b_bytes, "output_bytes": l_bytes + c_bytes,
                "alias_bytes": 0}
    return {"argument_bytes": p_bytes + c_bytes + b_bytes, "output_bytes": l_bytes + c_bytes,
            "alias_bytes": c_bytes}


def _probe_cfg(cfg, units: int):
    """Small config for cost extrapolation: ``units`` layers (periods for
    the hybrid), one microbatch, unchunked attention and MoE dispatch, no
    remat.  (The port's layers run as a Python loop: nothing to unroll.)"""
    fields = dict(microbatches_train=1, attn_q_chunk=1 << 30, moe_dispatch_tokens=1 << 30,
                  remat="none")
    if cfg.family == "hybrid":
        fields["num_layers"] = units * cfg.attn_period
    elif cfg.family == "encdec":
        fields["num_layers"] = units
        fields["encoder_layers"] = units
    else:
        fields["num_layers"] = units
    return dataclasses.replace(cfg, **fields)


def _units(cfg) -> int:
    return cfg.num_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.num_layers


def _depth_cfg(cfg, units: int):
    """``cfg`` cut to ``units`` layers (periods for the hybrid), every
    memory knob kept: the peak-memory probe."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=units * cfg.attn_period)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=units, encoder_layers=units)
    return dataclasses.replace(cfg, num_layers=units)


@dataclasses.dataclass
class _Traced:
    """What the dry run keeps of an (arch, shape)'s traces: global counts."""
    raw: analyze.CellCost  # the first trace (cost probe L=1, or the whole depth)
    peak_bytes: float  # at full depth
    logits: torch.Tensor | None  # a meta tensor of the serving step's logits
    probes: tuple | None = None  # (L=1, L=2) CellCosts
    full: analyze.CellCost | None = None  # extrapolated to full depth


def _summary(cfg, shape) -> tuple[analyze.CellCost, float, torch.Tensor | None]:
    """(global cost, peak bytes, logits) of one traced step; a serving step
    returns (logits, cache)."""
    tr = trace_cell(cfg, shape)
    logits = None if shape.kind == "train" else torch.empty_like(tr.out[0], device="meta")
    return tr.counter.cell_cost(), float(tr.peak_bytes), logits


def traced(cfg, shape, probes: bool) -> _Traced:
    """The (arch, shape)'s counts.  With ``probes``: cost from the two
    ``_probe_cfg`` traces, extrapolated; peak memory from two traces at 1
    and 2 units with the arch's own remat, chunking and microbatches,
    extrapolated.  Without: one trace of the whole depth."""
    if not probes:
        raw, peak, logits = _summary(cfg, shape)
        return _Traced(raw=raw, peak_bytes=peak, logits=logits)
    more = _units(cfg) - 1
    c1, _, logits = _summary(_probe_cfg(cfg, 1), shape)
    c2, _, _ = _summary(_probe_cfg(cfg, 2), shape)
    _, pk1, _ = _summary(_depth_cfg(cfg, 1), shape)
    _, pk2, _ = _summary(_depth_cfg(cfg, 2), shape)
    return _Traced(raw=c1, peak_bytes=pk1 + max(pk2 - pk1, 0.0) * more, logits=logits,
                   probes=(c1, c2), full=analyze.extrapolate(c1, c2, 1, more))


def _per_device(cost: analyze.CellCost, chips: int, note: str | None = None) -> dict:
    return {"flops": cost.flops / chips, "bytes_accessed": cost.bytes_accessed / chips,
            "coll_bytes": None, "coll_breakdown": {}, "note": note or NO_LM_COLLECTIVES}


# ---------------------------------------------------------------------------
# the KRR cell
# ---------------------------------------------------------------------------


def krr_mesh(mesh_name: str, device: str = "meta") -> SolverMesh:
    """The KRR cell's solver mesh: (16, 16), or (32, 16) on the multi-pod
    mesh, whose rows shard over ("pod", "data") (the reference's row-axes
    rule: every axis but "model")."""
    shape = (32, 16) if mesh_name == "multi" else (16, 16)
    return SolverMesh([device] * (shape[0] * shape[1]), shape=shape)


def krr_dist_config(kcfg) -> DistKRRConfig:
    return DistKRRConfig(
        n=kcfg.n, d=kcfg.d, kernel=kcfg.kernel, sigma=kcfg.sigma,
        lam_unscaled=kcfg.lam_unscaled, block_size=kcfg.block_size, rank=kcfg.rank,
    )


def krr_analytic_flops(dcfg: DistKRRConfig, powering_iters: int = 10) -> float:
    """The reference's analytic FLOPs of one step (all devices)."""
    b, n, d, r = dcfg.block_size, dcfg.n, dcfg.d, dcfg.rank
    return float(
        n * b * (3 * d + 2)  # g_B fused matvec
        + b * b * (3 * d + 2 * r)  # Nystrom sketch
        + powering_iters * b * b * (3 * d + 2)  # powering matvecs
    )


def krr_specs(dcfg: DistKRRConfig) -> tuple[dict, tuple, tuple]:
    """Physical specs of the step's state (a dict by field), x and y: rows
    over "data", everything else replicated."""
    vec = ("data",) if dcfg.heads == 1 else ("data", None)
    state = {"w": vec, "v": vec, "z": vec, "generator": (), "sketch_res": (), "pv": ()}
    return state, ("data", None), vec


def krr_argument_bytes(dcfg: DistKRRConfig, mesh) -> tuple[int, int]:
    """(argument bytes, state bytes) per device of the step's inputs."""
    state, x, y = abstract_dist_inputs(dcfg)
    s_specs, x_spec, y_spec = krr_specs(dcfg)
    s_bytes = sum(math.prod(mesh.shard_shape(s_specs[k], t.shape)) * t.element_size()
                  for k, t in state._asdict().items())
    rest = sum(math.prod(mesh.shard_shape(spec, t.shape)) * t.element_size()
               for spec, t in ((x_spec, x), (y_spec, y)))
    return s_bytes + rest, s_bytes


def trace_krr_step(dcfg: DistKRRConfig, mesh: SolverMesh) -> analyze.Trace:
    """One distributed ASkotch step on ``mesh`` (meta devices) with its
    block indices, Nystrom test matrix and powering probe injected."""
    step = make_dist_askotch_step(mesh, dcfg)
    state, x, y = abstract_dist_inputs(dcfg)
    b = dcfg.block_size
    draws = dict(idx=torch.empty((b,), dtype=torch.int64, device="meta"),
                 omega=torch.empty((b, dcfg.rank), dtype=torch.float32, device="meta"),
                 probe=torch.empty((b,), dtype=torch.float32, device="meta"))
    return analyze.trace_cost(step, state, x, y, **draws)


def krr_cell(dcfg: DistKRRConfig, mesh: SolverMesh) -> dict:
    """The KRR cell's memory and cost on ``mesh``, per device."""
    chips = mesh.size
    tr = trace_krr_step(dcfg, mesh)
    arg, state_bytes = krr_argument_bytes(dcfg, mesh)
    raw = tr.counter.cell_cost(chips)
    flops = krr_analytic_flops(dcfg)
    return {
        "compute_dtype": "float32",
        "memory": {"argument_bytes": arg, "output_bytes": state_bytes,
                   "temp_bytes": int(tr.peak_bytes / chips), "alias_bytes": state_bytes,
                   "temp_basis": TEMP_BASIS},
        "cost_raw": dataclasses.asdict(raw),
        "cost_extrapolated": {
            "flops": flops / chips, "bytes_accessed": raw.bytes_accessed,
            "coll_bytes": raw.coll_bytes, "coll_breakdown": raw.coll_breakdown,
            "note": "flops analytic (the reference's count); bytes traced (the port's "
                    "unfused ops and the kernels' analytic bytes); collectives the "
                    "mesh's operand bytes, every powering iteration counted",
        },
        "model_flops_total": flops,
        "kernel_calls": dict(tr.counter.kernels),  # on meta: nothing launches
    }


# ---------------------------------------------------------------------------
# a cell and the CLI
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_name: str, probes: bool,
             traces: dict | None = None) -> dict:
    """One cell's record.  ``traces`` (the caller's dict) keeps each (arch,
    shape)'s traces for its other mesh."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}

    if arch == KRR_ARCH:
        out = krr_cell(krr_dist_config(askotch_krr.config()), krr_mesh(mesh_name))
        rec.update(status="ok", **out)
        rec["seconds"] = round(time.time() - t0, 1)
        return rec

    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    rec.update(status="ok", **lm_cell(cfg, shape, mesh, probes, traces))
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def lm_cell(cfg, shape, mesh, probes: bool = True, traces: dict | None = None) -> dict:
    """An LM cell's memory and cost on ``mesh`` (an ``AbstractMesh`` or a
    ``SolverMesh``), per device; ``traces`` caches the traces by (config,
    shape, probes)."""
    chips = mesh.size
    traces = {} if traces is None else traces
    key = (cfg, shape, probes)
    if key not in traces:
        traces[key] = traced(cfg, shape, probes)
    tc = traces[key]
    mem = cell_memory(cfg, shape, mesh, tc.logits)
    mem["temp_bytes"] = int(tc.peak_bytes / chips)
    mem["temp_basis"] = TEMP_BASIS
    rec = dict(
        memory={k: mem[k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                    "alias_bytes", "temp_basis")},
        n_params=cfg.n_params(),
        n_active_params=cfg.n_active_params(),
        compute_dtype=cfg.dtype,
        cost_raw=_per_device(tc.raw, chips, "the first trace: probe L=1" if probes
                             else "the whole depth"),
    )
    if tc.full is not None:
        rec["cost_extrapolated"] = _per_device(tc.full, chips)
        rec["probe_raw"] = {"l1": _per_device(tc.probes[0], chips),
                            "l2": _per_device(tc.probes[1], chips)}
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    rec["tokens"] = tokens
    rec["model_flops_total"] = analyze.model_flops(
        cfg.n_params(), cfg.n_active_params(), tokens, shape.kind == "train"
    )
    return rec


def floor_s(rec: dict) -> float:
    """A record's roofline floor on one H100: its largest term (seconds)."""
    cost = rec.get("cost_extrapolated") or rec["cost_raw"]
    terms = analyze.roofline_terms(
        analyze.CellCost(cost["flops"], cost["bytes_accessed"], cost["coll_bytes"] or 0.0,
                         cost.get("coll_breakdown", {})),
        analyze.peak_for(rec.get("compute_dtype", "")))
    return max(terms["compute_s"], terms["memory_s"], terms["collective_s"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) + [KRR_ARCH] if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in ALL_SHAPES] if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    traces: dict = {}  # each (arch, shape) is traced once for both meshes
    for arch in archs:
        arch_shapes = ["krr_step"] if arch == KRR_ARCH else shapes
        for shape_name in arch_shapes:
            for mesh_name in meshes:
                tag = f"{arch}__{shape_name}__{mesh_name}".replace("/", "_")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}", flush=True)
                    continue
                try:
                    rec = run_cell(arch, shape_name, mesh_name, probes=not args.no_probes,
                                   traces=traces)
                except Exception as e:
                    rec = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "failed",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec.get("status")
                mem = rec.get("memory", {})
                gb = 1 / 2**30
                extra = (
                    f" arg={mem.get('argument_bytes', 0)*gb:.2f}G"
                    f" temp={mem.get('temp_bytes', 0)*gb:.2f}G"
                    if mem else f" ({rec.get('reason') or rec.get('error', '')[:80]})"
                )
                print(f"[{status}] {tag}{extra} {rec.get('seconds', 0)}s", flush=True)


if __name__ == "__main__":
    main()
