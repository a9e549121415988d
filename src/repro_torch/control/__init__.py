"""Closed-loop elastic control: detector → policy → actuator.

A numpy copy of ``repro.control``: for the same record stream it gives the
reference's verdicts and actions. Infers worker failures/stragglers from
observable telemetry only (no ground-truth masks) and drives the session's
live membership through typed :class:`ControlAction` values.
"""
from repro_torch.control.actions import ControlAction, SessionObserver
from repro_torch.control.actuator import (Actuator, AppliedAction,
                                          RuleController, make_controller)
from repro_torch.control.detector import (FAILED_SUSPECT, HEALTHY,
                                          STRAGGLER_SUSPECT, VERDICTS,
                                          DetectorConfig, FailureDetector)
from repro_torch.control.policy import (MembershipPolicy, PolicyConfig,
                                        RulePolicy, make_policy)

__all__ = [
    "ControlAction", "SessionObserver",
    "DetectorConfig", "FailureDetector",
    "HEALTHY", "STRAGGLER_SUSPECT", "FAILED_SUSPECT", "VERDICTS",
    "MembershipPolicy", "PolicyConfig", "RulePolicy", "make_policy",
    "Actuator", "AppliedAction", "RuleController", "make_controller",
]
