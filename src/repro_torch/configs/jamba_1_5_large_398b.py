"""jamba-1.5-large-398b [arXiv:2403.19887; hf]: Mamba+attention hybrid MoE.

72L (9 periods x 8), d_model=8192, 64H (GQA kv=8), expert d_ff=24576,
vocab=65536, 16 experts top-2 on every other layer, attention:mamba = 1:7.
No positional encoding in attention (Mamba carries position).  Hybrid state
is O(1) for the 63 Mamba sublayers + a KV cache for the 9 attention
sublayers -> runs long_500k with the cache seq dim sharded over "tp".
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536, num_experts=16, top_k=2,
        attn_period=8, moe_every=2, d_state=16, ssm_expand=2, ssm_conv=4,
        rope_fraction=0.0, tie_embeddings=False,
        dtype="bfloat16", param_dtype="bfloat16", sub_quadratic=True,
        optimizer="adafactor", remat="full", microbatches_train=8,
        grad_accum_dtype="bfloat16", fsdp_over_pod=True,
        source="arXiv:2403.19887; hf",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, num_experts=4, top_k=2, attn_period=4,
        d_state=8, dtype="float32", param_dtype="float32",
        remat="none", microbatches_train=1, grad_accum_dtype="float32",
        fsdp_over_pod=False,
    )
