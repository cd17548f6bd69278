"""whisper-base [arXiv:2212.04356; unverified]: enc-dec audio transformer.

6L encoder + 6L decoder, d_model=512, 8 heads (kv=8), d_ff=2048,
vocab=51865 (padded to 51968 for 16-way TP x 128 lanes).  The conv audio
frontend is a stub: input_specs() provides precomputed frame embeddings.
Deviations (DESIGN.md §5/§8): sinusoidal decoder positions (the real learned
448-position table does not extend to the assigned 4k/32k shapes).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="encdec",
        num_layers=6, encoder_layers=6, d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=51865,
        norm="layernorm", mlp_act="gelu", tie_embeddings=True,
        dtype="bfloat16", param_dtype="float32",
        optimizer="adamw", remat="full", microbatches_train=1,
        source="arXiv:2212.04356; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, dtype="float32",
        remat="none",
    )
