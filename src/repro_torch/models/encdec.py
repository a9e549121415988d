"""Encoder-decoder backbone (``repro.models.encdec``): the text/speech
backbone of seamless-m4t-large-v2. arXiv:2308.11596.

The modality frontend (mel-spectrogram + conv feature extractor) is a
stub, as in the reference: the batch carries precomputed frame embeddings
``src`` (B, S_enc, d_model). The encoder is a non-causal pre-norm
transformer; each decoder layer adds causal self-attention and
cross-attention over the encoder's memory. The parameter tree is the
reference's, leaf for leaf (``embed``, ``enc_layers``, ``enc_norm``,
``dec_layers``, ``final_norm``; the stacks with a leading layer axis,
walked by a Python loop in place of ``lax.scan``). The decode cache is
``{"k", "v"}``, the decoder's self-attention K/V (L, B, S, KVH, D),
updated in place, and ``{"xk", "xv"}``, the cross-attention K/V of the
memory, which ``prefill`` computes once and returns as new tensors: the
source may have any length, ``enc_len`` only sizes the cache's
placeholders.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.dense import DecoderLM, _layer, as_tree
from repro_torch.nn import layers
from repro_torch.nn.param import ParamSpec, stack_specs, zeros_init


def _enc_block_specs(cfg: ModelConfig):
    return {"ln1": layers.norm_specs(cfg),
            "attn": layers.attention_specs(cfg),
            "ln2": layers.norm_specs(cfg),
            "mlp": layers.mlp_specs(cfg)}


def _dec_block_specs(cfg: ModelConfig):
    return {"ln1": layers.norm_specs(cfg),
            "self_attn": layers.attention_specs(cfg),
            "ln_x": layers.norm_specs(cfg),
            "cross_attn": layers.attention_specs(cfg, cross=True),
            "ln2": layers.norm_specs(cfg),
            "mlp": layers.mlp_specs(cfg)}


class EncDecLM:
    """``spec`` is the parameter tree; params are nested dicts of tensors
    on one device, and every method computes there."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.spec = {
            "embed": layers.embedding_specs(cfg),
            "enc_layers": stack_specs(_enc_block_specs(cfg), cfg.enc_layers),
            "enc_norm": layers.norm_specs(cfg),
            "dec_layers": stack_specs(_dec_block_specs(cfg), cfg.dec_layers),
            "final_norm": layers.norm_specs(cfg),
        }

    def enc_len(self, dec_len: int) -> int:
        return max(128, dec_len // self.cfg.enc_seq_ratio)

    def _src(self, batch):
        """The batch's source frames; a batch without them raises naming
        the arch (the reference fails with ``KeyError: 'src'``)."""
        if "src" not in batch:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder: its batch needs "
                "source frames 'src' (B, S_enc, d_model) beside the tokens "
                "(ServeEngine.generate(..., extra_batch={'src': ...}))")
        return batch["src"]

    # -- encoder --------------------------------------------------------------
    def encode(self, params, src):
        """src (B, Se, d) → memory (B, Se, d) in the activation dtype."""
        cfg = self.cfg
        B, Se, _ = src.shape
        pos = api.default_positions(B, Se, src.device)
        angles = layers.rope_angles(pos, cfg)
        x = src.to(cfg.adtype)
        for i in range(cfg.enc_layers):
            lp = _layer(params["enc_layers"], i)
            u = layers.apply_norm(lp["ln1"], x, cfg)
            a, _ = layers.multihead_attention(lp["attn"], u, cfg,
                                              angles=angles, q_pos=pos,
                                              causal=False)
            x = x + a
            u = layers.apply_norm(lp["ln2"], x, cfg)
            x = x + layers.apply_mlp(lp["mlp"], u, cfg)
        return layers.apply_norm(params["enc_norm"], x, cfg)

    # -- decoder --------------------------------------------------------------
    def _decode_stack(self, params, x, memory, *, q_pos, angles, cache=None,
                      cache_index=None):
        """Without a cache, cross-attention reads ``memory``; with one, the
        cache's ``xk`` / ``xv`` and the self-attention K/V are written at
        ``cache_index``."""
        cfg = self.cfg
        for i in range(cfg.dec_layers):
            lp = _layer(params["dec_layers"], i)
            u = layers.apply_norm(lp["ln1"], x, cfg)
            a, _ = layers.multihead_attention(
                lp["self_attn"], u, cfg, angles=angles, q_pos=q_pos,
                cache=None if cache is None else {"k": cache["k"][i],
                                                  "v": cache["v"][i]},
                cache_index=cache_index)
            x = x + a
            u = layers.apply_norm(lp["ln_x"], x, cfg)
            if cache is None:
                c, _ = layers.multihead_attention(lp["cross_attn"], u, cfg,
                                                  kv_x=memory, q_pos=q_pos)
            else:
                c, _ = layers.multihead_attention(
                    lp["cross_attn"], u, cfg, q_pos=q_pos, causal=False,
                    kv_precomputed=(cache["xk"][i], cache["xv"][i]))
            x = x + c
            u = layers.apply_norm(lp["ln2"], x, cfg)
            x = x + layers.apply_mlp(lp["mlp"], u, cfg)
        return x

    def cross_kv(self, params, memory):
        """Each decoder layer's cross-attention K/V of the memory:
        (L, B, Se, KVH, D) each."""
        dt = memory.dtype
        ks, vs = [], []
        for i in range(self.cfg.dec_layers):
            ap = _layer(params["dec_layers"], i)["cross_attn"]
            ks.append(torch.einsum("bsd,dhk->bshk", memory, ap["wk"].to(dt)))
            vs.append(torch.einsum("bsd,dhk->bshk", memory, ap["wv"].to(dt)))
        return torch.stack(ks), torch.stack(vs)

    def forward(self, params, batch):
        """→ (logits (B, S, V), a float32 zero: no aux loss)."""
        cfg = self.cfg
        memory = self.encode(params, self._src(batch))
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        B, S, _ = x.shape
        pos = api.default_positions(B, S, x.device)
        x = self._decode_stack(params, x, memory, q_pos=pos,
                               angles=layers.rope_angles(pos, cfg))
        x = layers.apply_norm(params["final_norm"], x, cfg)
        return (layers.unembed(params["embed"], x, cfg),
                torch.zeros((), device=x.device))

    # -- decode ---------------------------------------------------------------
    def cache_spec(self, batch_size: int, cache_len: int):
        cfg = self.cfg
        kv = lambda s: ParamSpec((cfg.dec_layers, batch_size, s, cfg.kv_heads,
                                  cfg.hd), cfg.adtype, zeros_init)
        Se = self.enc_len(cache_len)
        return {"k": kv(cache_len), "v": kv(cache_len), "xk": kv(Se),
                "xv": kv(Se)}

    init_cache = DecoderLM.init_cache  # zeros of ``cache_spec``

    def prefill(self, params, batch, cache):
        """Encode ``src``, replace the cache's cross K/V by the memory's,
        then run the target prefix."""
        memory = self.encode(params, self._src(batch))
        xk, xv = self.cross_kv(params, memory)
        return self._step(params, batch, dict(cache, xk=xk, xv=xv), 0)

    def decode_step(self, params, batch, cache, index):
        return self._step(params, batch, cache, index)

    def _step(self, params, batch, cache, index):
        cfg = self.cfg
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        B, q_len, _ = x.shape
        pos = api.default_positions(B, q_len, x.device) + index
        x = self._decode_stack(params, x, None, q_pos=pos,
                               angles=layers.rope_angles(pos, cfg),
                               cache=cache, cache_index=index)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        return layers.unembed(params["embed"], x, cfg), cache

    def loss(self, params, batch):
        """``params``: a nested tree or the trainer's flat views."""
        logits, aux = self.forward(as_tree(params), batch)
        ce = api.cross_entropy(logits, batch["targets"])
        return ce, {"ce": ce, "aux": aux}
