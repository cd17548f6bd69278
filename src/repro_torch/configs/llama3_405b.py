"""llama3-405b [arXiv:2407.21783; unverified]: the heavyweight dense cell.

126L, d_model=16384, 128H (GQA kv=8), d_ff=53248, vocab=128256.
Memory posture (DESIGN.md §4 / EXPERIMENTS.md): bf16 params + Adafactor +
seq-sharded residual + 16 microbatches + bf16 grad accumulation; on the
multi-pod mesh FSDP spans ("pod","data") (fsdp_over_pod), which is what
brings the train_4k cell under 16 GB/chip — single-pod train is reported
as marginally over HBM (matches reality: 405B-class training needs >256
chips).
"""

import dataclasses

from repro_torch.models.model_api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        d_ff=53248, vocab_size=128256, tie_embeddings=False,
        dtype="bfloat16", param_dtype="bfloat16",
        optimizer="adafactor", remat="full", microbatches_train=16,
        grad_accum_dtype="bfloat16", fsdp_over_pod=True,
        source="arXiv:2407.21783; unverified",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
        remat="none", microbatches_train=1, grad_accum_dtype="float32",
        fsdp_over_pod=False,
    )
