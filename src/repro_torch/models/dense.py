"""Decoder-only transformer LM, dense family (``repro.models.dense``).

Covers the dense configurations that use RMSNorm, a SwiGLU MLP and tied
embeddings (qwen3-4b); every other feature of the family — layernorm,
gelu, untied unembeddings (stablelm-3b, h2o-danube-1.8b), M-RoPE, and the
MoE layers of ``nn/moe.py`` — raises by name. The parameter tree is the
reference's, leaf for leaf: ``embed``, ``final_norm`` and the stacked
``dense_layers`` with a leading layer axis, which a Python loop walks in
place of the reference's ``lax.scan``. The KV cache is ``{"dense": {"k",
"v"}}`` of shape (layers, B, S, KVH, D) and is updated in place: the
``cache`` that ``prefill``/``decode_step`` return is the one passed in.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.nn import layers
from repro_torch.nn.param import (ParamSpec, stack_specs, tree_from_leaves,
                                  tree_leaves, zeros_init)


def _block_specs(cfg: ModelConfig):
    return {"ln1": layers.norm_specs(cfg), "attn": layers.attention_specs(cfg),
            "ln2": layers.norm_specs(cfg), "mlp": layers.mlp_specs(cfg)}


def _apply_block(bp, x, cfg: ModelConfig, *, angles, q_pos, cache=None,
                 cache_index=None):
    h = layers.apply_norm(bp["ln1"], x, cfg)
    a, _ = layers.multihead_attention(bp["attn"], h, cfg, angles=angles,
                                      q_pos=q_pos, cache=cache,
                                      cache_index=cache_index)
    x = x + a
    h = layers.apply_norm(bp["ln2"], x, cfg)
    return x + layers.apply_mlp(bp["mlp"], h, cfg)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderLM:
    """``spec`` is the parameter tree; params are nested dicts of tensors
    on one device, and every method computes there."""

    def __init__(self, cfg: ModelConfig):
        if cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: mixture-of-experts layers (nn/moe.py) are not "
                "ported to PyTorch yet")
        unported = [f"{k}={getattr(cfg, k)!r}" for k, ported in (
            ("norm", cfg.norm == "rmsnorm"), ("act", cfg.act == "swiglu"),
            ("tie_embeddings", cfg.tie_embeddings),
            ("rope_mode", cfg.rope_mode != "mrope")) if not ported]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} (nn/layers.py) not "
                "ported to PyTorch yet")
        self.cfg = cfg
        self.n_dense = cfg.num_layers
        self.spec = {
            "embed": layers.embedding_specs(cfg),
            "final_norm": layers.norm_specs(cfg),
            "dense_layers": stack_specs(_block_specs(cfg), cfg.num_layers),
        }

    # -- full-sequence forward (train / logits) ------------------------------
    def forward(self, params, batch):
        """→ (logits (B, S, V), aux loss 0)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        B, S, _ = x.shape
        pos = api.default_positions(B, S, x.device)
        angles = layers.rope_angles(pos, cfg)
        for i in range(self.n_dense):
            x = _apply_block(_layer(params["dense_layers"], i), x, cfg,
                             angles=angles, q_pos=pos)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.unembed(params["embed"], x, cfg)
        return logits, torch.zeros((), device=x.device)

    # -- decode ---------------------------------------------------------------
    def cache_spec(self, batch_size: int, cache_len: int):
        cfg = self.cfg
        kv = ParamSpec((self.n_dense, batch_size, cache_len, cfg.kv_heads,
                        cfg.hd), cfg.adtype, zeros_init)
        return {"dense": {"k": kv, "v": kv}}

    def init_cache(self, batch_size: int, cache_len: int, device="cpu"):
        return tree_from_leaves(
            (path, torch.zeros(s.shape, dtype=s.dtype, device=device))
            for path, s in tree_leaves(self.cache_spec(batch_size,
                                                       cache_len)))

    def _with_cache(self, params, batch, cache, index):
        """``index``: an int, or a (B, 1) tensor of per-row offsets."""
        cfg = self.cfg
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        B, q_len, _ = x.shape
        q_pos = api.default_positions(B, q_len, x.device) + index
        angles = layers.rope_angles(q_pos, cfg)
        ck, cv = cache["dense"]["k"], cache["dense"]["v"]
        for i in range(self.n_dense):
            x = _apply_block(_layer(params["dense_layers"], i), x, cfg,
                             angles=angles, q_pos=q_pos,
                             cache={"k": ck[i], "v": cv[i]},
                             cache_index=index)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        return layers.unembed(params["embed"], x, cfg), cache

    def prefill(self, params, batch, cache):
        return self._with_cache(params, batch, cache, 0)

    def decode_step(self, params, batch, cache, index):
        return self._with_cache(params, batch, cache, index)

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch)
        ce = api.cross_entropy(logits, batch["targets"])
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
