"""Model API of the port: architecture config, shape config, the family
registry and parameter trees — the counterpart of ``repro.models.model_api``.

Every assigned architecture is one ``ArchConfig`` (the published numbers live
in ``repro_torch/configs/<id>.py``) handled by one of five family modules
(dense / moe / vlm share ``transformer.py``):

  dense | moe | vlm  -> transformer.py   (decoder-only, GQA, optional MoE FFN,
                                          optional provided prefix embeddings)
  rwkv               -> rwkv6.py         (attention-free, Finch)
  hybrid             -> hybrid.py        (Jamba: mamba/attention interleave + MoE)
  encdec             -> encdec.py        (Whisper: encoder + cross-attn decoder)

Each family module registers a ``ModelImpl`` of plain functions over a nested
dict of tensors, layers stacked on a leading L axis exactly as ``param_defs``
lays them out; the dotted paths of ``param_defs`` are the single source of
truth for shapes, and carry weights across from the JAX package by name
(``repro_torch.convert.lm_params_from_reference``).

A ``param_defs`` entry is ``(shape, spec)`` where ``spec`` is a tuple of
logical axis names ("tp", "fsdp", "dp" or None), element for element the JAX
package's ``PartitionSpec``.  On one device the specs are data only.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.device import resolve_device

# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | rwkv | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0  # 0 -> num_heads
    head_dim: int = 0  # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE FFN on layers where (layer % moe_every == moe_every-1)
    capacity_factor: float = 1.25
    # attention flavor
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # chatglm3 "2d" RoPE == rotary on half the head dim
    rope_theta: float = 10000.0
    mlp_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # ssm / hybrid
    attn_period: int = 0  # hybrid: one attention layer per `attn_period` layers
    d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # enc-dec / modality stubs
    encoder_layers: int = 0
    num_prefix_tokens: int = 0  # VLM patches / audio frames fed as embeddings
    tie_embeddings: bool = True
    # numerics & training knobs (per arch, the JAX package's values; its
    # residual_shard and scan_unroll steer XLA's sharding hints and loop
    # unrolling, which the port has no use for)
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor | sgdm
    remat: str = "full"  # full | dots | none (recompute under autograd only)
    microbatches_train: int = 1
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator dtype
    fsdp_over_pod: bool = False  # multi-pod: shard params over ("pod","data")
    #   (32-way FSDP) instead of pure cross-pod DP (the dry run's rules)
    attn_q_chunk: int = 512  # query-chunk size for exact tiled attention
    moe_dispatch_tokens: int = 32_768  # tokens per MoE routing round
    moe_combine_dtype: str = "auto"  # "auto" (= activation dtype) | "float32"
    sub_quadratic: bool = False  # can run long_500k
    source: str = ""  # provenance note ([arXiv/hf; tier])

    # -- derived -------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def padded_vocab(self, tp: int = 16, lane: int = 128) -> int:
        """Pad vocab so it shards over tp and tiles the 128-lane registers."""
        mult = tp * lane // math.gcd(tp, lane)
        return -(-self.vocab_size // mult) * mult

    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def parameter_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def n_params(self) -> int:
        """Total parameter count (from the registered param defs)."""
        defs = get_model(self).param_defs(self)
        return sum(math.prod(shape) for shape, _ in defs.values())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top_k + shared)."""
        defs = get_model(self).param_defs(self)
        total = 0
        for name, (shape, _) in defs.items():
            count = math.prod(shape)
            if _is_routed_expert(name) and self.num_experts > self.top_k > 0:
                count = count * self.top_k // self.num_experts
            total += count
        return total


def _is_routed_expert(name: str) -> bool:
    return "moe_" in name and "router" not in name and "shared" not in name


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k requires sub-quadratic sequence mixing (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: O(L^2) attention infeasible at 524k"
    return True, ""


# ----------------------------------------------------------------------------
# family implementation protocol
# ----------------------------------------------------------------------------

# param_defs: cfg -> {path: ((shape...), spec)} — single source of truth
ParamDefs = dict[str, tuple[tuple[int, ...], tuple]]


class ModelImpl(NamedTuple):
    param_defs: Callable[[ArchConfig], ParamDefs]
    loss_fn: Callable[..., Any]  # (params, batch, cfg) -> (loss, metrics)
    prefill: Callable[..., Any]  # (params, batch, cfg) -> (logits, cache)
    decode_step: Callable[..., Any]  # (params, cache, batch, cfg) -> (logits, cache)
    init_cache: Callable[..., Any]  # (cfg, batch, seq, abstract=False, *, device) -> cache
    cache_specs: Callable[..., Any]  # (cfg, batch, seq) -> dict of spec tuples
    input_specs: Callable[..., Any]  # (cfg, shape) -> dict of meta tensors


_REGISTRY: dict[str, ModelImpl] = {}
_FAMILY_MODULES = ("transformer", "rwkv6", "hybrid", "encdec")


def register_family(name: str, impl: ModelImpl) -> None:
    _REGISTRY[name] = impl


def get_model(cfg: ArchConfig) -> ModelImpl:
    # dense / moe / vlm all route to the decoder-only transformer
    family = {"dense": "transformer", "moe": "transformer", "vlm": "transformer"}.get(
        cfg.family, cfg.family
    )
    if family not in _REGISTRY:  # the family modules register themselves on import
        for mod in _FAMILY_MODULES:
            importlib.import_module(f"repro_torch.models.{mod}")
    return _REGISTRY[family]


# ----------------------------------------------------------------------------
# parameter trees from defs
# ----------------------------------------------------------------------------


def unflatten(flat: dict[str, Any]) -> dict:
    """'a.b.c' keyed dict -> nested dicts."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dicts -> 'a.b.c' keyed dict (the inverse of :func:`unflatten`)."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, f"{path}."))
        else:
            out[path] = v
    return out


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` over every leaf of a nested dict (e.g. ``lambda t: t.to(dev)``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(generator: torch.Generator, cfg: ArchConfig, scale: float = 0.02, *,
                device="cuda") -> dict:
    """Materialize parameters from param_defs on ``device``: ones for
    ``*scale``, zeros for ``*bias``, ``*a_log_bias`` and ``.b_*``, otherwise
    ``scale`` x standard normal drawn (in path order) from ``generator``,
    which lives on ``device``.  The streams are torch's, not JAX's."""
    dev = resolve_device(device)
    defs = get_model(cfg).param_defs(cfg)
    dtype = cfg.parameter_dtype()
    flat = {}
    for path, (shape, _spec) in sorted(defs.items()):
        if path.endswith("scale"):
            flat[path] = torch.ones(shape, dtype=dtype, device=dev)
        elif path.endswith(("bias", "a_log_bias")) or ".b_" in path:
            flat[path] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
            flat[path] = w.mul_(scale).to(dtype)
    return unflatten(flat)


def abstract_params(cfg: ArchConfig) -> dict:
    """Meta-tensor tree (shapes and dtypes, no allocation)."""
    defs = get_model(cfg).param_defs(cfg)
    dtype = cfg.parameter_dtype()
    return unflatten({path: torch.empty(shape, dtype=dtype, device="meta")
                      for path, (shape, _) in defs.items()})


def param_pspecs(cfg: ArchConfig) -> dict:
    """Spec tree matching the param tree, in logical axis names."""
    defs = get_model(cfg).param_defs(cfg)
    return unflatten({path: spec for path, (shape, spec) in defs.items()})


def stacked(tree: dict, n: int) -> list[dict]:
    """The n slices of a dict of tensors stacked on a leading axis (views):
    the Python loop that stands in for the reference's ``lax.scan`` over it.
    ``torch.unbind`` makes the slices: under autograd its one backward
    stacks the n slice gradients once, where n ``v[i]`` would each write a
    zero-filled gradient the size of the whole stack."""
    cols = {k: torch.unbind(v) for k, v in tree.items()}
    for k, c in cols.items():
        assert len(c) == n, (k, len(c), n)
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def cache_tensors(shapes: dict[str, tuple], dtype, seq: int, abstract: bool, device,
                  ) -> dict[str, torch.Tensor]:
    """Zero tensors (one allocation each: decode writes them in place) or
    meta tensors for ``abstract``, plus ``pos``: seq - 1, or a meta scalar."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    out: dict[str, Any] = {}
    for name, shape in shapes.items():
        dt = dtype[name] if isinstance(dtype, dict) else dtype
        out[name] = torch.zeros(shape, dtype=dt, device=dev)
    out["pos"] = torch.tensor(seq - 1, dtype=torch.int32, device=dev)
    return out
