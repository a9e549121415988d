"""Helpers shared by the model families (``repro.models.api``): positions
and the token-level loss. Batches are plain dicts of tensors; tokens are
integers."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """Mean token-level cross entropy; logits (B,S,V) any dtype."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def default_positions(batch_size: int, seq_len: int, device=None):
    return torch.arange(seq_len, device=device).expand(batch_size, seq_len)
