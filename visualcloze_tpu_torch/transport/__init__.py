"""Flow transport of the port: training losses and the Euler sampler."""

from .transport import ModelType, PathType, Transport, create_transport

__all__ = ["ModelType", "PathType", "Transport", "create_transport"]
