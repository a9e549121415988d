"""Typed live-control vocabulary for the session.

The session's live-control surface used to be two ad-hoc methods
(``resize()`` / ``set_membership()``). The closed-loop controller needs a
*value* it can produce, log, rate-limit and replay — so control is now a
datatype: :class:`ControlAction` describes one membership edit and
``ElasticSession.apply(action)`` is the single entrypoint that executes it.
The old methods survive as deprecated wrappers that build the equivalent
action.

:class:`SessionObserver` is the hook protocol both the rule controller
(``repro_torch.control.actuator.RuleController``) and user callbacks attach
through: ``on_round(record)`` fires once per completed round with the
host-side :class:`repro_torch.api.session.RoundRecord`;
``on_chunk_end(session)`` fires between chunks — the only point where
membership may change — and is where a controller calls
``session.apply(...)``.

This module is deliberately leaf-level (numpy only): the session imports it
for ``apply``'s signature and every ``repro_torch.control`` module builds on
it, with no import cycle through ``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

ACTION_KINDS = ("evict", "readmit", "resize", "set_membership", "noop")


@dataclasses.dataclass(frozen=True)
class ControlAction:
    """One membership edit, as a value.

    ``kind`` selects the payload: ``evict``/``readmit`` name slot indices,
    ``resize`` carries the target live-worker count ``k``,
    ``set_membership`` a full (capacity,) bool mask, and ``noop`` nothing
    (it exists so a policy's "decided to do nothing" is loggable). Build
    instances through the classmethods — they validate the payload shape at
    construction; ``ElasticSession.apply`` validates against the live pool.
    ``reason`` is free-form provenance (which detector verdict produced
    this), carried into the actuator log.
    """

    kind: str
    slots: Tuple[int, ...] = ()
    k: int = 0
    mask: Optional[np.ndarray] = None
    reason: str = ""

    def __post_init__(self):
        if self.kind not in ACTION_KINDS:
            raise ValueError(f"ControlAction.kind must be one of "
                             f"{ACTION_KINDS}, got {self.kind!r}")
        if self.kind in ("evict", "readmit"):
            if not self.slots:
                raise ValueError(f"{self.kind} action needs >= 1 slot")
            if any(s < 0 for s in self.slots):
                raise ValueError(f"{self.kind} slots must be >= 0, "
                                 f"got {self.slots}")
        if self.kind == "resize" and self.k < 1:
            raise ValueError(f"resize target must be >= 1, got {self.k}")
        if self.kind == "set_membership" and self.mask is None:
            raise ValueError("set_membership action needs a mask")

    # -- constructors --------------------------------------------------------
    @classmethod
    def evict(cls, slots, reason: str = "") -> "ControlAction":
        """Retire the given live slots (their data shards are re-dealt to
        the survivors; the slots freeze until readmitted)."""
        return cls("evict", slots=tuple(int(s) for s in slots),
                   reason=reason)

    @classmethod
    def readmit(cls, slots, reason: str = "") -> "ControlAction":
        """Re-activate the given vacant slots; they rejoin at the next
        round cold-started from the master (EASGD admission)."""
        return cls("readmit", slots=tuple(int(s) for s in slots),
                   reason=reason)

    @classmethod
    def resize(cls, k: int, reason: str = "") -> "ControlAction":
        """Resize the live pool to ``k`` workers: growing activates the
        lowest-numbered vacant slots, shrinking retires the highest live
        ones."""
        return cls("resize", k=int(k), reason=reason)

    @classmethod
    def set_membership(cls, mask, reason: str = "") -> "ControlAction":
        """Replace the live mask wholesale with the given (capacity,)
        bools."""
        return cls("set_membership", mask=np.asarray(mask, bool),
                   reason=reason)

    @classmethod
    def noop(cls, reason: str = "") -> "ControlAction":
        return cls("noop", reason=reason)

    def describe(self) -> str:
        body = {"evict": f"evict slots {list(self.slots)}",
                "readmit": f"readmit slots {list(self.slots)}",
                "resize": f"resize pool to k={self.k}",
                "set_membership": (
                    "set membership "
                    f"{self.mask.astype(int).tolist()}"
                    if self.mask is not None else "set membership"),
                "noop": "no-op"}[self.kind]
        return f"{body} ({self.reason})" if self.reason else body


@runtime_checkable
class SessionObserver(Protocol):
    """Hook protocol for anything watching a running ``ElasticSession``.

    Both hooks are optional at runtime (the session feature-checks with
    ``getattr``), so a bare callback object implementing only ``on_round``
    is a valid observer. ``on_chunk_end`` runs between chunks — the only
    point where ``session.apply(action)`` is legal — and receives the live
    session, so a controller can both read (``active_mask``, ``round``) and
    act.
    """

    def on_round(self, record: Any) -> None:
        """Called once per completed round with its ``RoundRecord``."""

    def on_chunk_end(self, session: Any) -> None:
        """Called after each chunk, before the next one is built."""
