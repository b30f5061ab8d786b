"""The VisualCloze pipeline of the port."""

from . import preprocessing
from .loader import build_visualcloze, random_components, synthetic_full_components
from .visualcloze import VisualClozeModel

__all__ = ["VisualClozeModel", "build_visualcloze", "preprocessing", "random_components",
           "synthetic_full_components"]
