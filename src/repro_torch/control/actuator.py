"""Actuator: applies policy actions to the session at chunk boundaries.

Membership is only mutable between chunks (``ElasticSession`` bakes the
live mask into each chunk's schedule rows), so the control loop runs on the
session's observer hooks: ``on_round`` streams each completed round's
telemetry into the detector; ``on_chunk_end`` — the one legal mutation
point — asks the policy for actions and pushes them through
``session.apply``. :class:`RuleController` bundles detector + policy +
actuator into a single
:class:`~repro_torch.control.actions.SessionObserver` that
``RunSpec(controller="rules")`` attaches automatically.

Every application is journalled as an :class:`AppliedAction` (round,
action, whether it took effect, live count after), so a closed-loop run's
whole membership story is replayable from ``controller.actuator.log``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.control.actions import ControlAction
from repro_torch.control.detector import DetectorConfig, FailureDetector
from repro_torch.control.policy import (MembershipPolicy, PolicyConfig,
                                        RulePolicy)


@dataclasses.dataclass(frozen=True)
class AppliedAction:
    """Journal entry: one action as actually applied (or skipped)."""

    round: int
    action: ControlAction
    applied: bool
    live_after: int
    note: str = ""


class Actuator:
    """Pushes :class:`ControlAction` lists into a session, safely.

    Skips (and journals) actions that are no longer applicable when the
    chunk boundary arrives: evicting an already-vacant slot, readmitting a
    live one, or acting after the run's final round.
    """

    def __init__(self):
        self.log: List[AppliedAction] = []

    def apply(self, session, actions) -> int:
        """Apply actions in order; returns how many took effect."""
        applied = 0
        for action in actions:
            note = ""
            ok = False
            if action.kind == "noop":
                note = "noop"
            elif session.round >= session.spec.rounds:
                note = "run complete"
            else:
                act = session.active_mask
                if action.kind == "evict":
                    slots = tuple(s for s in action.slots if act[s])
                    note = "" if slots == action.slots else "some vacant"
                    if slots and len(slots) < int(act.sum()):
                        session.apply(dataclasses.replace(
                            action, slots=slots))
                        ok = True
                    elif slots:
                        note = "would empty pool"
                elif action.kind == "readmit":
                    slots = tuple(s for s in action.slots if not act[s])
                    note = "" if slots == action.slots else "some live"
                    if slots:
                        session.apply(dataclasses.replace(
                            action, slots=slots))
                        ok = True
                else:  # resize / set_membership pass straight through
                    session.apply(action)
                    ok = True
            applied += ok
            self.log.append(AppliedAction(
                round=session.round, action=action, applied=ok,
                live_after=int(session.active_mask.sum()), note=note))
        return applied


class RuleController:
    """Detector + policy + actuator as one session observer.

    Attach with ``RunSpec(controller="rules")`` (the session builds one via
    :func:`make_controller`) or manually with ``session.add_observer``.
    """

    def __init__(self, capacity: int,
                 detector: Optional[DetectorConfig] = None,
                 policy: Optional[PolicyConfig] = None):
        self.detector = FailureDetector(capacity, detector)
        self.policy: MembershipPolicy = RulePolicy(policy)
        self.actuator = Actuator()

    # -- SessionObserver ------------------------------------------------------
    def on_round(self, record) -> None:
        self.detector.observe(record)

    def on_chunk_end(self, session) -> None:
        if session.round >= session.spec.rounds:
            return
        actions = self.policy.decide(self.detector.verdicts(),
                                     session.active_mask, session.round)
        self.actuator.apply(session, actions)


def make_controller(name: str, capacity: int,
                    detector: Optional[DetectorConfig] = None,
                    policy: Optional[PolicyConfig] = None) -> RuleController:
    """Controller factory behind ``RunSpec.controller`` / ``--controller``."""
    if name != "rules":
        raise ValueError(f"unknown controller {name!r}; available: 'rules'")
    return RuleController(capacity, detector=detector, policy=policy)
