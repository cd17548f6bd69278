"""chatglm3-6b [arXiv:2406.12793; hf]: dense GQA with partial ("2d") RoPE.

28L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024; rotary applied
to half the head dim (rope_fraction=0.5); untied output layer.
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024, rope_fraction=0.5, tie_embeddings=False,
        dtype="bfloat16", param_dtype="float32",
        optimizer="adamw", remat="full", microbatches_train=1,
        source="arXiv:2406.12793; hf",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32",
        remat="none",
    )
