"""Membership policy: detector verdicts → typed control actions.

The detector says *what it believes* about each slot; the policy decides
*what to do about it*, under operational guardrails the detector shouldn't
know about: a minimum pool size (evicting below it would stall training
more than a bad worker does), a per-decision action budget (rate limiting —
one noisy chunk must not churn the whole pool), and a per-slot cooldown so
an evict→readmit→evict cycle can't flap faster than the detector's own
hysteresis resolves.

:class:`MembershipPolicy` is the plug-in base: ``decide(verdicts, active,
round)`` returns a list of :class:`ControlAction` for the actuator to apply
at the next chunk boundary. :class:`RulePolicy` is the rule-based instance
the ``--controller rules`` flag wires in: evict FAILED/STRAGGLER suspects
(down to the floor, worst-first), readmit slots the policy itself evicted
once their verdict returns to healthy (the detector's probe-readmission
signal — see ``detector.py``: a dark slot's recovery is unobservable, so
"healthy again" means "cooldown elapsed, probe it").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.control.actions import ControlAction
from repro_torch.control.detector import (FAILED_SUSPECT, HEALTHY,
                                          STRAGGLER_SUSPECT)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Guardrails for :class:`RulePolicy`.

    ``min_pool`` — never evict below this many live slots;
    ``max_actions`` — at most this many evict/readmit actions per decision;
    ``slot_cooldown`` — rounds a slot must wait between membership flips;
    ``evict_stragglers`` — whether straggler suspects are evicted too (off
    leaves them in the pool for the paper's dynamic weighting to down-weight,
    which is the right call when spare capacity is scarce).
    """

    min_pool: int = 2
    max_actions: int = 2
    slot_cooldown: int = 2
    evict_stragglers: bool = True


class MembershipPolicy:
    """Base protocol: override :meth:`decide`."""

    def decide(self, verdicts: Sequence[str], active: np.ndarray,
               round: int) -> List[ControlAction]:
        raise NotImplementedError

    def reset(self) -> None:
        """Forget slot history (new run)."""


class RulePolicy(MembershipPolicy):
    """Evict suspects, probe-readmit healed slots, respect guardrails."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.cfg = config or PolicyConfig()
        self._evicted: Dict[int, int] = {}   # slot -> round we evicted it
        self._last_flip: Dict[int, int] = {}  # slot -> round of last action
        self.decisions: List[ControlAction] = []  # full action log

    def reset(self) -> None:
        self._evicted.clear()
        self._last_flip.clear()
        self.decisions.clear()

    def _cooled(self, slot: int, round: int) -> bool:
        last = self._last_flip.get(slot)
        return last is None or round - last >= self.cfg.slot_cooldown

    def decide(self, verdicts: Sequence[str], active: np.ndarray,
               round: int) -> List[ControlAction]:
        cfg = self.cfg
        active = np.asarray(active, bool)
        actions: List[ControlAction] = []
        budget = cfg.max_actions

        # 1) readmit: slots *we* evicted whose verdict is healthy again
        #    (detector cooldown elapsed -> probe). Never readmit slots that
        #    are vacant for other reasons (planned schedules own those).
        probe = sorted(s for s, _ in self._evicted.items()
                       if not active[s] and verdicts[s] == HEALTHY
                       and self._cooled(s, round))
        if probe and budget > 0:
            take = probe[:budget]
            budget -= 1
            actions.append(ControlAction.readmit(
                take, reason="probe-readmit after cooldown"))
            for s in take:
                del self._evicted[s]
                self._last_flip[s] = round

        # 2) evict: failed suspects first, then stragglers, worst-first,
        #    never below the floor
        live = int(active.sum()) + sum(
            1 for a in actions if a.kind == "readmit"
            for _ in a.slots)
        headroom = live - cfg.min_pool
        suspects = [s for s in range(len(verdicts))
                    if active[s] and verdicts[s] == FAILED_SUSPECT
                    and self._cooled(s, round)]
        if cfg.evict_stragglers:
            suspects += [s for s in range(len(verdicts))
                         if active[s] and verdicts[s] == STRAGGLER_SUSPECT
                         and self._cooled(s, round)]
        take = suspects[:max(0, min(headroom, budget))]
        if take:
            kinds = {s: verdicts[s] for s in take}
            actions.append(ControlAction.evict(
                sorted(take),
                reason="; ".join(f"slot {s}: {kinds[s]}"
                                 for s in sorted(take))))
            for s in take:
                self._evicted[s] = round
                self._last_flip[s] = round

        if not actions:
            actions.append(ControlAction.noop(reason="all healthy"))
        self.decisions.extend(actions)
        return actions


def make_policy(name: str, config: Optional[PolicyConfig] = None
                ) -> MembershipPolicy:
    if name != "rules":
        raise ValueError(f"unknown policy {name!r}; available: 'rules'")
    return RulePolicy(config)
