"""Qwen2-VL-style vision-language backbone (``repro.models.vlm``): the
dense GQA decoder with M-RoPE and patch inputs. arXiv:2409.12191.

The vision frontend (ViT + merger) is a stub, as in the reference: the
batch carries precomputed patch embeddings ``patches`` (B, Np, d_model),
prepended to the text embeddings in the activation dtype. M-RoPE splits
each rotary half into (temporal, height, width) sections; vision tokens
sit at grid coordinates (0, h, w), text tokens at equal (t, h, w) from the
grid extent on (one image per sample). A batch without ``patches`` is
text only: its positions are the decode positions ``offset -
num_patch_tokens`` on, so a text-only prompt rotates by negative
positions, as the reference's. The loss is taken over the text logits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import api
from repro_torch.models.dense import DecoderLM, as_tree
from repro_torch.nn import layers


class VLM(DecoderLM):
    @property
    def grid(self) -> int:
        return max(1, int(math.sqrt(self.cfg.num_patch_tokens)))

    def _mrope_positions(self, B, n_patch, n_text, offset=0, device=None):
        """(3, B, n_patch + n_text) positions: the patches at (0, h, w) of
        the grid, the text at (t, t, t) from the grid extent, all shifted
        by ``offset``."""
        g = self.grid
        idx = torch.arange(n_patch, device=device)
        vis = torch.stack([torch.zeros_like(idx), idx // g, idx % g])
        txt = (g + torch.arange(n_text, device=device)).expand(3, n_text)
        pos = torch.cat([vis, txt], dim=1) if n_patch else txt
        return pos[:, None].expand(3, B, n_patch + n_text) + offset

    def positions(self, batch, B, S, offset=0, device=None):
        if "patches" in batch:
            n_patch = batch["patches"].shape[1]
            return self._mrope_positions(B, n_patch, S - n_patch, offset,
                                         device)
        # decode: the global index ``offset`` counts patches and text, but
        # the text's M-RoPE positions advance from the grid extent by the
        # text index only
        return self._mrope_positions(
            B, 0, S, offset - self.cfg.num_patch_tokens, device)

    def input_embeds(self, params, batch):
        txt = layers.embed(params["embed"], batch["tokens"], self.cfg)
        if "patches" in batch:
            return torch.cat([batch["patches"].to(self.cfg.adtype), txt],
                             dim=1)
        return txt

    def loss(self, params, batch):
        logits, aux = self.forward(as_tree(params), batch)
        n_patch = batch["patches"].shape[1] if "patches" in batch else 0
        ce = api.cross_entropy(logits[:, n_patch:], batch["targets"])
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
