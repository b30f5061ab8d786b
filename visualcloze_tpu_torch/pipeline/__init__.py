"""The VisualCloze pipeline of the port."""

from . import preprocessing
from .diffusers_api import VisualClozePipeline, VisualClozePipelineOutput
from .loader import build_visualcloze, random_components, synthetic_full_components
from .orchestrator import PipelinedServer, ReplicaPool
from .visualcloze import VisualClozeModel

__all__ = ["PipelinedServer", "ReplicaPool", "VisualClozeModel", "VisualClozePipeline", "VisualClozePipelineOutput",
           "build_visualcloze", "preprocessing", "random_components", "synthetic_full_components"]
