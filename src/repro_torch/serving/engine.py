"""Static-batch serving engine: prefill + greedy decode over a KV cache.

The port of ``repro.serving.engine``. One fixed batch in, one batch of
generations out; EOS pinning and short-circuiting on the host. Not
continuous batching — every request starts together and the batch runs to
completion (``repro_torch.serving.continuous`` is the in-flight engine).
``ServeEngine`` is the port's own **bit-exactness reference**: the
continuous engine reproduces its tokens on the degenerate
all-arrive-at-t0 batch (``tests/test_torch_serving.py``). Every tensor
lives on the device of ``params``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(eq=False)
class ServeEngine:
    model: object
    params: object
    max_len: int = 256

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, *, steps: int = 32,
                 eos_id: Optional[int] = None,
                 extra_batch=None) -> np.ndarray:
        """prompts (B, S0) int → (B, ≤steps) int32 generated tokens
        (greedy; the width shrinks only when every row hits ``eos_id``
        early). Rows that have emitted ``eos_id`` are pinned to it, and the
        pinned token is what is fed back. A request that could decode past
        the ``max_len`` KV positions is rejected up front.

        ``extra_batch`` (arrays or tensors, e.g. an encoder-decoder's
        ``src`` frames) joins the prefill batch on the engine's device. The
        decode index starts at the text length ``S0``, as in the
        reference's engine; a VLM prefill with ``patches`` would put the
        decode's K/V and positions at patch slots, so ``patches`` raise:
        drive ``prefill`` / ``decode_step`` at the global index for
        those."""
        B, S0 = prompts.shape
        if S0 + steps > self.max_len:
            raise ValueError(
                f"generate: prompt length {S0} + steps {steps} = "
                f"{S0 + steps} overruns the KV cache (max_len="
                f"{self.max_len}); raise max_len or request fewer steps")
        if extra_batch and "patches" in extra_batch:
            raise NotImplementedError(
                "generate: extra_batch carries 'patches', but the decode "
                f"index starts at the text length {S0} and would land on "
                "patch slots; call the model's prefill / decode_step at "
                "the global index (patches + text) instead")
        dev = self.params["embed"]["embedding"].device
        cache = self.model.init_cache(B, self.max_len, dev)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev)}
        for key, val in (extra_batch or {}).items():
            batch[key] = torch.as_tensor(val, device=dev)
        logits, cache = self.model.prefill(self.params, batch, cache)
        tok = logits[:, -1:].argmax(-1)
        out = [tok.cpu().numpy()]
        finished = np.zeros(B, bool)
        if eos_id is not None:
            finished |= out[0][:, 0] == eos_id
        index = S0
        for _ in range(steps - 1):
            if eos_id is not None and finished.all():
                break
            logits, cache = self.model.decode_step(
                self.params, {"tokens": tok}, cache, index)
            tok = logits[:, -1:].argmax(-1)
            if eos_id is not None:
                tok = torch.where(torch.as_tensor(finished, device=dev)[:, None],
                                  eos_id, tok)
            t_np = tok.cpu().numpy()
            out.append(t_np)
            index += 1
            if eos_id is not None:
                finished |= t_np[:, 0] == eos_id
        return np.concatenate(out, axis=1).astype(np.int32)
