"""qwen2-1.5b [arXiv:2407.10671; hf]: dense GQA with QKV bias.

28L, d_model=1536, 12H (GQA kv=2), d_ff=8960, vocab=151936, tied embeddings.
12 heads don't split 16-way, so attention runs TP-replicated (DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        dtype="bfloat16", param_dtype="float32",
        optimizer="adamw", remat="full", microbatches_train=1,
        source="arXiv:2407.10671; hf",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=192, vocab_size=256, dtype="float32",
        remat="none",
    )
