"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified].

64L, d_model=12288, 96H (GQA kv=8), d_ff=33792, vocab=256000, no biases.
Deviation (DESIGN.md §8): embedding/head storage untied — a tied 6.3 GB
table under 2D sharding forces SPMD to replicate it on gather; untied
storage keeps both the gather and the logits matmul cleanly partitioned.
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b", family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=33792, vocab_size=256000, tie_embeddings=False,
        dtype="bfloat16", param_dtype="bfloat16",
        optimizer="adafactor", remat="full", microbatches_train=4,
        grad_accum_dtype="bfloat16", fsdp_over_pod=True,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
        remat="none", microbatches_train=1, grad_accum_dtype="float32",
        fsdp_over_pod=False,
    )
