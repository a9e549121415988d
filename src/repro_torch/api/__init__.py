"""Run API of the port: ``RunSpec`` → ``ElasticSession``."""
from repro_torch.api.session import ElasticSession, RoundRecord, RunSpec

__all__ = ["ElasticSession", "RoundRecord", "RunSpec"]
