"""numpy datasets and episodic samplers (no torch, no JAX): arrays go to
the card with ``torch.from_numpy(...).to(device)`` at the caller."""

from repro_torch.data.episodic import EpisodicSampler, split_classes
from repro_torch.data.synthetic import (
    GlyphClasses,
    KeywordAudio,
    arch_batch,
    lm_batch,
)

__all__ = ["EpisodicSampler", "split_classes", "GlyphClasses",
           "KeywordAudio", "arch_batch", "lm_batch"]
