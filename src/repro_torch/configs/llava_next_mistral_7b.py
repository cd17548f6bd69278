"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Mistral-7B backbone: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=32000.  The anyres vision tower is a stub: input_specs() provides
2880 precomputed patch embeddings (5 tiles x 576 patches) prepended to the
text tokens; seq_len counts prefix + text (DESIGN.md §5).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b", family="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, num_prefix_tokens=2880,
        tie_embeddings=False,
        dtype="bfloat16", param_dtype="float32",
        optimizer="adamw", remat="full", microbatches_train=2,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, num_prefix_tokens=8, dtype="float32",
        remat="none", microbatches_train=1,
    )
