"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE.

28L, d_model=2048, 16H (kv=16 = MHA), per-expert d_ff=1408, vocab=102400,
2 shared + 64 routed experts top-6.  64 experts shard expert-parallel over
the 16-way "model" axis (4 experts/chip).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400, num_experts=64, top_k=6,
        num_shared_experts=2, tie_embeddings=False,
        dtype="bfloat16", param_dtype="float32",
        optimizer="adamw", remat="full", microbatches_train=2,
        source="arXiv:2401.06066; hf",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256, num_experts=8, top_k=2, num_shared_experts=1,
        dtype="float32",
        remat="none", microbatches_train=1,
    )
