"""build_model(cfg) — family dispatch (``repro.models.registry``) over the
families the port runs; every other family raises naming itself."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def build_model(cfg_or_arch, smoke: bool = False):
    cfg = (cfg_or_arch if isinstance(cfg_or_arch, ModelConfig)
           else get_config(cfg_or_arch, smoke=smoke))
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.dense import DecoderLM

        return DecoderLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM

        return VLM(cfg)
    if cfg.family == "cnn":
        from repro_torch.models.cnn import PaperCNN

        return PaperCNN(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported to "
        "PyTorch yet (ported: dense, moe, encdec, vlm, cnn)")
