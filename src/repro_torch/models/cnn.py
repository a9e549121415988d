"""The paper's own model: a simple 2-conv-layer CNN for 28×28 10-class
classification ("a simple 2-layer convolutional neural network from PyTorch",
paper §VI — the canonical PyTorch MNIST example: conv(1→32,3×3),
conv(32→64,3×3), maxpool 2×2, fc(9216→128), fc(128→10)).

The math mirrors ``repro.models.cnn.PaperCNN``: NHWC images, HWIO conv
kernels applied as an im2col float32 ``torch.matmul`` (not a cuDNN
convolution, which would run in TF32 by default and reassociate
differently), a reshape-max pool and a logsumexp − gold loss. The
functional :meth:`PaperCNN.logits` takes ``{leaf name: tensor}`` so the
trainer can feed it views of its flat buffers and run it under
``torch.func``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.param import ParamSpec, fan_in_init, init_tree, zeros_init


def _conv(x, w, b):
    """3×3 VALID conv via im2col matmul (x NHWC, w HWIO)."""
    B, Hh, Ww, C = x.shape
    kh, kw, _, O = w.shape
    oh, ow = Hh - kh + 1, Ww - kw + 1
    cols = torch.stack(
        [x[:, i:i + oh, j:j + ow, :] for i in range(kh) for j in range(kw)],
        dim=3)  # (B, oh, ow, kh*kw, C)
    cols = cols.reshape(B, oh, ow, kh * kw * C)
    return cols @ w.reshape(kh * kw * C, O) + b


def _maxpool2(x):
    """2×2 max pool via reshape."""
    B, Hh, Ww, C = x.shape
    return x.reshape(B, Hh // 2, 2, Ww // 2, 2, C).amax(dim=(2, 4))


class _Dense(nn.Module):
    """One layer's ``w`` and ``b``, named as in the reference tree."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.b = nn.Parameter(b)  # b before w: the reference's leaf order
        self.w = nn.Parameter(w)


class PaperCNN(nn.Module):
    """``named_parameters()`` yields ``conv1.b, conv1.w, …`` — the flat
    layout's leaf names. ``generator`` seeds the module's own parameters;
    the trainer keeps its parameters in flat buffers and calls
    :meth:`logits`/:meth:`loss` with views of them."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        f32 = torch.float32
        self.spec = {
            "conv1": {"w": ParamSpec((3, 3, 1, 32), f32, fan_in_init(2)),
                      "b": ParamSpec((32,), f32, zeros_init)},
            "conv2": {"w": ParamSpec((3, 3, 32, 64), f32, fan_in_init(2)),
                      "b": ParamSpec((64,), f32, zeros_init)},
            "fc1": {"w": ParamSpec((9216, 128), f32, fan_in_init(0)),
                    "b": ParamSpec((128,), f32, zeros_init)},
            "fc2": {"w": ParamSpec((128, 10), f32, fan_in_init(0)),
                    "b": ParamSpec((10,), f32, zeros_init)},
        }
        gen = generator or torch.Generator().manual_seed(0)
        for name, leaf in init_tree(gen, self.spec).items():
            self.add_module(name, _Dense(leaf["w"], leaf["b"]))

    @staticmethod
    def logits(params: Dict[str, torch.Tensor], images: torch.Tensor
              ) -> torch.Tensor:
        x = torch.relu(_conv(images, params["conv1.w"], params["conv1.b"]))
        x = torch.relu(_conv(x, params["conv2.w"], params["conv2.b"]))
        x = _maxpool2(x)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ params["fc1.w"] + params["fc1.b"])
        return x @ params["fc2.w"] + params["fc2.b"]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.logits(dict(self.named_parameters()), images)

    def loss(self, params, batch):
        """(mean cross-entropy, {"ce", "acc"}) on ``batch`` (images NHWC,
        integer labels)."""
        logits = self.logits(params, batch["images"]).float()
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
        ce = (logz - gold).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return ce, {"ce": ce, "acc": acc}

    def accuracy(self, params, batch):
        logits = self.logits(params, batch["images"])
        return (logits.argmax(-1) == batch["labels"].long()).float().mean()
