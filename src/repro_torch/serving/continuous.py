"""Continuous (in-flight) batching engine over a fixed request-slot pool.

The port of ``repro.serving.continuous``. The KV cache and every per-step
input are shaped at ``capacity`` slots, an active mask marks the live
ones, and requests join / finish / are evicted between decode steps.

- **admit** — the prompt is right-padded to the fixed ``prefill_len``
  bucket and prefilled alone at batch 1 into a scratch cache of exactly
  ``prefill_len`` positions, so every layer's attention is a full-sequence
  call (``Sq == Skv``) and runs the flash-attention kernel on the card.
  The first generated token is the argmax at the real last prompt position
  ``L-1`` (padding positions are causally invisible to it), and the
  scratch KV is adopted into the slot's row of the pool cache. Padding KV
  at ``L..prefill_len-1`` is garbage that decode overwrites before any
  query can see it.
- **decode** — one pooled step for all ``capacity`` rows with per-slot
  cache indices (``multihead_attention``'s vector ``cache_index``).
  Vacant rows compute garbage that is masked out of the returned tokens;
  rows do not interact.
- **finish** — on EOS / token budget the slot is freed on the host; the
  next admit overwrites its cache row.

Each ``admit`` and ``step`` reads its tokens back to the host, as the
reference does, so a scheduler's wall-clock timing covers finished device
work. Parameters can be swapped between decode steps (``swap_params``);
in-flight requests continue on their already-written KV.

The reference's ``jit_cache_sizes`` (its zero-recompile check) has no
counterpart here: PyTorch runs eagerly and traces nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.nn.param import tree_leaves

SUPPORTED_FAMILIES = ("dense", "moe")
CACHE_BATCH_AXIS = 1  # (layers, batch, positions, kv heads, head dim)


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    """One completed (or evicted) request, materialized on the host."""

    rid: int
    slot: int
    tokens: np.ndarray  # (n_generated,) int32, includes the EOS token
    reason: str  # "eos" | "length" | "evicted"
    prompt_len: int
    admitted_tick: int
    finished_tick: int

    @property
    def num_tokens(self) -> int:
        return int(self.tokens.size)


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt_len: int
    budget: int  # remaining new tokens
    eos_id: Optional[int]
    tokens: List[int]
    admitted_tick: int


class ContinuousEngine:
    """Fixed-shape request-slot pool with in-flight batching.

    ``capacity`` is the max simultaneous requests, ``max_len`` the KV
    positions per slot (prompt + generated), ``prefill_len`` the fixed
    prompt bucket every admission pads to. Everything runs on the device
    of ``params``.
    """

    def __init__(self, model, params, *, capacity: int = 8,
                 max_len: int = 256, prefill_len: int = 32,
                 eos_id: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 1 <= prefill_len <= max_len:
            raise ValueError(
                f"need 1 <= prefill_len ({prefill_len}) <= max_len "
                f"({max_len})")
        fam = model.cfg.family
        if fam not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"continuous batching serves decoder-LM families "
                f"{SUPPORTED_FAMILIES} in the port; {model.cfg.name!r} is "
                f"family {fam!r}")
        self.model = model
        self.params = params
        self.capacity = capacity
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.eos_id = eos_id
        self.device = params["embed"]["embedding"].device
        self.cache = model.init_cache(capacity, max_len, self.device)
        # every admit's prefill overwrites all prefill_len positions, so
        # one scratch cache serves them all
        self._scratch = model.init_cache(1, prefill_len, self.device)
        # host-side pool state
        self._tok = np.zeros((capacity, 1), np.int32)  # last token per slot
        self._pos = np.zeros((capacity,), np.int32)  # next KV write index
        self._active = np.zeros((capacity,), bool)
        self._slots: Dict[int, _Slot] = {}
        self._done: List[FinishedRequest] = []
        self.ticks = 0  # decode steps executed
        self.swaps = 0  # hot swaps applied

    # -- device bodies ---------------------------------------------------------
    @torch.no_grad()
    def _admit_impl(self, toks: torch.Tensor, length: int, slot: int) -> int:
        """(1, prefill_len) padded prompt → first token; the scratch KV is
        adopted into the pool row ``slot``."""
        logits, scratch = self.model.prefill(
            self.params, {"tokens": toks}, self._scratch)
        tok0 = logits[0, length - 1].argmax()
        for (_, pool), (_, single) in zip(tree_leaves(self.cache),
                                          tree_leaves(scratch)):
            pool.narrow(CACHE_BATCH_AXIS, slot, 1)[:, :, :self.prefill_len] \
                = single
        return int(tok0)

    @torch.no_grad()
    def _decode_impl(self, tok, idx, active) -> np.ndarray:
        """One token for every slot; per-slot cache indices ``idx``
        ((capacity, 1)). Vacant rows are masked to 0."""
        logits, self.cache = self.model.decode_step(
            self.params, {"tokens": tok}, self.cache, idx)
        nxt = logits[:, -1].argmax(-1)
        return torch.where(active, nxt, 0).cpu().numpy().astype(np.int32)

    # -- pool introspection --------------------------------------------------
    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def vacant_slots(self) -> List[int]:
        return np.flatnonzero(~self._active).tolist()

    def active_slots(self) -> List[int]:
        return np.flatnonzero(self._active).tolist()

    # -- lifecycle -----------------------------------------------------------
    def admit(self, prompt, *, max_new: int, eos_id=None,
              rid: Optional[int] = None) -> int:
        """Seat one request in a vacant slot; returns the slot. The first
        generated token comes out of the prefill itself, so a request can
        finish here (EOS at token 1 / max_new == 1) without ever decoding.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        L = int(prompt.size)
        if not 1 <= L <= self.prefill_len:
            raise ValueError(
                f"prompt length {L} outside 1..prefill_len="
                f"{self.prefill_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if L + max_new > self.max_len:
            raise ValueError(
                f"prompt {L} + max_new {max_new} overruns the slot's KV "
                f"row (max_len={self.max_len})")
        vacant = self.vacant_slots()
        if not vacant:
            raise RuntimeError("pool full: no vacant slot to admit into")
        slot = vacant[0]
        eos = self.eos_id if eos_id is None else eos_id
        padded = np.zeros((1, self.prefill_len), np.int32)
        padded[0, :L] = prompt
        t0 = self._admit_impl(torch.as_tensor(padded, device=self.device),
                              L, slot)
        self._tok[slot, 0] = t0
        self._pos[slot] = L
        self._active[slot] = True
        self._slots[slot] = _Slot(
            rid=rid if rid is not None else slot, prompt_len=L,
            budget=max_new - 1, eos_id=eos, tokens=[t0],
            admitted_tick=self.ticks)
        self._maybe_finish(slot)
        return slot

    def _maybe_finish(self, slot: int) -> None:
        s = self._slots[slot]
        if s.eos_id is not None and s.tokens[-1] == s.eos_id:
            self._finish(slot, "eos")
        elif s.budget <= 0:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str) -> None:
        s = self._slots.pop(slot)
        self._active[slot] = False
        self._done.append(FinishedRequest(
            rid=s.rid, slot=slot, tokens=np.asarray(s.tokens, np.int32),
            reason=reason, prompt_len=s.prompt_len,
            admitted_tick=s.admitted_tick, finished_tick=self.ticks))

    def evict(self, slot: int) -> None:
        """Forcibly finish a live slot (deadline miss, shutdown); its
        partial output is returned through ``drain_finished`` with reason
        ``"evicted"``."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not live")
        self._finish(slot, "evicted")

    def drain_finished(self) -> List[FinishedRequest]:
        done, self._done = self._done, []
        return done

    def step(self) -> List[FinishedRequest]:
        """One pooled decode tick (no-op when nothing is live); returns
        every request that finished by the end of the tick — including
        ones that finished at admit/evict time since the last drain."""
        if self._active.any():
            dev = self.device
            nxt = self._decode_impl(
                torch.as_tensor(self._tok, device=dev),
                torch.as_tensor(self._pos[:, None], device=dev),
                torch.as_tensor(self._active, device=dev))
            self.ticks += 1
            live = np.flatnonzero(self._active)
            self._pos[live] += 1
            for slot in live.tolist():
                t = int(nxt[slot])
                s = self._slots[slot]
                s.tokens.append(t)
                s.budget -= 1
                self._tok[slot, 0] = t
                self._maybe_finish(slot)
        return self.drain_finished()

    # -- hot swap ------------------------------------------------------------
    def swap_params(self, new_params) -> None:
        """Flip the served parameters between decode steps. The new tree
        must match the live one leaf for leaf (paths, shapes, dtypes,
        device); in-flight requests keep their KV from the old parameters
        and continue."""
        old, new = tree_leaves(self.params), tree_leaves(new_params)
        if [p for p, _ in old] != [p for p, _ in new]:
            raise ValueError("swap_params: tree structure mismatch")
        for (path, a), (_, b) in zip(old, new):
            if (a.shape != b.shape or a.dtype != b.dtype
                    or a.device != b.device):
                raise ValueError(
                    f"swap_params: leaf {'/'.join(path)} "
                    f"{tuple(b.shape)}/{b.dtype}/{b.device} != "
                    f"{tuple(a.shape)}/{a.dtype}/{a.device}")
        self.params = new_params
        self.swaps += 1
