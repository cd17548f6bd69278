"""LM data pipeline: deterministic and resumable — the port of
``repro.data.pipeline``.

The iterator is a pure function of (seed, step): each batch is
``synthetic.batch_for(cfg, (batch, seq), seed, step)`` on ``device``, so its
state is the step counter, a checkpoint stores that one integer, and a
resumed run sees the batches the uninterrupted run would have seen, bit for
bit.  The state dict has the reference's keys, so a data cursor crosses
between the packages; the tokens come from the port's generator (torch's
streams, not JAX's).
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models.model_api import ArchConfig


class LMDataPipeline:
    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.device = resolve_device(device)

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg, batch, seq, state: dict, device="cuda"):
        return cls(cfg, batch, seq, seed=state["seed"], start_step=state["step"],
                   device=device)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = synthetic.batch_for(self.cfg, (self.batch, self.seq), self.seed, self.step,
                                device=self.device)
        self.step += 1
        return b
