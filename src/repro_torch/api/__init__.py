"""Run API of the port: ``RunSpec`` → ``ElasticSession``, and the
closed-loop control surface (``ControlAction``, ``MembershipPolicy``,
``SessionObserver``), as ``repro.api`` exports them."""
from repro_torch.api.session import ElasticSession, RoundRecord, RunSpec
from repro_torch.control.actions import ControlAction, SessionObserver
from repro_torch.control.policy import MembershipPolicy

__all__ = ["ElasticSession", "RoundRecord", "RunSpec",
           "ControlAction", "MembershipPolicy", "SessionObserver"]
