"""rwkv6-1.6b "Finch" [arXiv:2404.05892; unverified]: attention-free SSM.

24L, d_model=2048 (32 heads x 64), d_ff=7168, vocab=65536, data-dependent
per-channel decay.  O(1) recurrent state -> runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b", family="rwkv",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536, tie_embeddings=False,
        dtype="bfloat16", param_dtype="float32", sub_quadratic=True,
        optimizer="adamw", remat="full", microbatches_train=4,
        source="arXiv:2404.05892; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        d_ff=256, vocab_size=256, dtype="float32",
        remat="none",
    )
