"""Flow transport of the port: training losses and the samplers."""

from .sampling import Sampler, denoise_ode, denoise_ode_adaptive, denoise_sde, sample_ode_likelihood
from .transport import ModelType, PathType, Transport, create_transport

__all__ = ["ModelType", "PathType", "Sampler", "Transport", "create_transport", "denoise_ode",
           "denoise_ode_adaptive", "denoise_sde", "sample_ode_likelihood"]
