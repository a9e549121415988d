"""Decoder-only transformer LM, dense and MoE variants (``repro.models.dense``).

Covers the dense configurations (qwen3-4b, stablelm-3b, h2o-danube-1.8b)
and the mixture-of-experts ones (mixtral-8x22b, llama4-scout-17b-a16e,
moonshot-v1-16b-a3b, with first dense layers and shared experts):
RMSNorm or LayerNorm, SwiGLU, GeGLU or GELU MLPs or the experts of
``nn/moe.py``, tied or untied unembeddings, full or partial rotary,
sliding windows and attention chunks. ``positions`` and
``input_embeds`` are the reference's hooks, which ``models/vlm.py``
overrides (M-RoPE positions, patch embeddings before the text). The
parameter tree is the reference's, leaf for leaf: ``embed`` (with
``unembed`` when untied), ``final_norm``, and the stacked
``dense_layers`` (every layer of a dense model, the first
``first_dense_layers`` of an MoE one) and ``moe_layers``, each with a
leading layer axis, which a Python loop walks in place of the
reference's ``lax.scan``. ``forward`` returns the router aux loss summed
over the MoE layers (a float32 zero without them); the cached calls drop
it. The KV cache is ``{"dense": {"k", "v"}, "moe": {"k", "v"}}`` (each
part present when its stack is), of shape (layers, B, S, KVH, D), and is
updated in place: the ``cache`` that ``prefill``/``decode_step`` return
is the one passed in.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.nn import layers, moe as moe_lib
from repro_torch.nn.param import (ParamSpec, stack_specs, tree_from_leaves,
                                  tree_leaves, zeros_init)


def _block_specs(cfg: ModelConfig, use_moe: bool):
    p = {"ln1": layers.norm_specs(cfg), "attn": layers.attention_specs(cfg),
         "ln2": layers.norm_specs(cfg)}
    if use_moe:
        p["moe"] = moe_lib.moe_specs(cfg)
    else:
        p["mlp"] = layers.mlp_specs(cfg)
    return p


def _apply_block(bp, x, cfg: ModelConfig, use_moe: bool, *, angles, q_pos,
                 cache=None, cache_index=None):
    """→ (x, aux): the router aux of an MoE block, else None."""
    h = layers.apply_norm(bp["ln1"], x, cfg)
    a, _ = layers.multihead_attention(bp["attn"], h, cfg, angles=angles,
                                      q_pos=q_pos, cache=cache,
                                      cache_index=cache_index)
    x = x + a
    h = layers.apply_norm(bp["ln2"], x, cfg)
    if use_moe:
        m, aux = moe_lib.apply_moe(bp["moe"], h, cfg)
    else:
        m, aux = layers.apply_mlp(bp["mlp"], h, cfg), None
    return x + m, aux


def as_tree(params):
    """A nested parameter tree, or the trainer's flat views keyed by dotted
    leaf name (``FlatLayout.views``) made into one."""
    if "embed" in params:
        return params
    return tree_from_leaves((tuple(name.split(".")), leaf)
                            for name, leaf in params.items())


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderLM:
    """``spec`` is the parameter tree; params are nested dicts of tensors
    on one device, and every method computes there."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        n_dense = cfg.first_dense_layers if cfg.moe else cfg.num_layers
        self.n_dense, self.n_moe = n_dense, cfg.num_layers - n_dense
        self.spec = {"embed": layers.embedding_specs(cfg),
                     "final_norm": layers.norm_specs(cfg)}
        if self.n_dense:
            self.spec["dense_layers"] = stack_specs(
                _block_specs(cfg, False), self.n_dense)
        if self.n_moe:
            self.spec["moe_layers"] = stack_specs(_block_specs(cfg, True),
                                                  self.n_moe)

    def _stacks(self):
        """(params key, cache key, use_moe, layers) of each stack, in the
        reference's order: dense first."""
        return [s for s in (("dense_layers", "dense", False, self.n_dense),
                            ("moe_layers", "moe", True, self.n_moe)) if s[3]]

    # -- positions / embeddings ---------------------------------------------
    def positions(self, batch, B, S, offset=0, device=None):
        """Rope positions of S inputs from ``offset`` (an int or a (B, 1)
        tensor): (B, S)."""
        del batch
        return api.default_positions(B, S, device) + offset

    def input_embeds(self, params, batch):
        return layers.embed(params["embed"], batch["tokens"], self.cfg)

    # -- full-sequence forward (train / logits) ------------------------------
    def forward(self, params, batch):
        """→ (logits (B, S, V), the router aux summed over the MoE layers:
        a float32 scalar, 0 without them). The rope angles come from
        ``positions``; the mask positions are sequential."""
        cfg = self.cfg
        x = self.input_embeds(params, batch)
        B, S, _ = x.shape
        angles = layers.rope_angles(
            self.positions(batch, B, S, device=x.device), cfg)
        q_pos = api.default_positions(B, S, x.device)
        aux_total = torch.zeros((), device=x.device)
        for key, _, use_moe, n in self._stacks():
            for i in range(n):
                x, aux = _apply_block(_layer(params[key], i), x, cfg, use_moe,
                                      angles=angles, q_pos=q_pos)
                if aux is not None:
                    aux_total = aux_total + aux
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.unembed(params["embed"], x, cfg)
        return logits, aux_total

    # -- decode ---------------------------------------------------------------
    def cache_spec(self, batch_size: int, cache_len: int):
        cfg = self.cfg
        spec = {}
        for _, ckey, _, n in self._stacks():
            kv = ParamSpec((n, batch_size, cache_len, cfg.kv_heads, cfg.hd),
                           cfg.adtype, zeros_init)
            spec[ckey] = {"k": kv, "v": kv}
        return spec

    def init_cache(self, batch_size: int, cache_len: int, device="cpu"):
        return tree_from_leaves(
            (path, torch.zeros(s.shape, dtype=s.dtype, device=device))
            for path, s in tree_leaves(self.cache_spec(batch_size,
                                                       cache_len)))

    def _with_cache(self, params, batch, cache, index):
        """``index``: an int, or a (B, 1) tensor of per-row offsets. The
        query length counts every input embedding (a VLM's patches and
        text)."""
        cfg = self.cfg
        x = self.input_embeds(params, batch)
        B, q_len, _ = x.shape
        angles = layers.rope_angles(
            self.positions(batch, B, q_len, index, x.device), cfg)
        q_pos = api.default_positions(B, q_len, x.device) + index
        for key, ckey, use_moe, n in self._stacks():
            ck, cv = cache[ckey]["k"], cache[ckey]["v"]
            for i in range(n):
                x, _ = _apply_block(_layer(params[key], i), x, cfg, use_moe,
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
        """``params``: a nested tree, or the trainer's flat views keyed by
        dotted leaf name (``FlatLayout.views``), as the CNN takes them."""
        logits, aux = self.forward(as_tree(params), batch)
        ce = api.cross_entropy(logits, batch["targets"])
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
