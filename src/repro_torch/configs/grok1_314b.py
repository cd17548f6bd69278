"""grok-1-314b [hf:xai-org/grok-1; unverified]: 314B MoE decoder-only.

64L, d_model=6144, 48H (GQA kv=8), expert d_ff=32768, vocab=131072,
8 experts top-2.  8 experts don't split over 16-way TP, so expert FFNs are
tensor-parallel on the ffn dim instead of expert-parallel (DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, vocab_size=131072, num_experts=8, top_k=2,
        tie_embeddings=False,
        dtype="bfloat16", param_dtype="bfloat16",
        optimizer="adafactor", remat="full", microbatches_train=8,
        grad_accum_dtype="bfloat16", fsdp_over_pod=True,
        source="hf:xai-org/grok-1; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, num_experts=4, top_k=2, dtype="float32",
        param_dtype="float32",
        remat="none", microbatches_train=1, grad_accum_dtype="float32",
        fsdp_over_pod=False,
    )
