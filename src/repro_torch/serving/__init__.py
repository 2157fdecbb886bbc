"""The online serving front end of the port (``repro.serving``)."""
from repro_torch.serving.batcher import (
    BatchedServer,
    ServeConfig,
    ServerNotReadyError,
    ServerOverloadError,
    quorum_merge,
)

__all__ = ["BatchedServer", "ServeConfig", "ServerNotReadyError",
           "ServerOverloadError", "quorum_merge"]
