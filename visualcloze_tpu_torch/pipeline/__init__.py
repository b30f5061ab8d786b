"""The VisualCloze pipeline of the port."""

from . import preprocessing
from .loader import random_components, synthetic_full_components
from .visualcloze import VisualClozeModel

__all__ = ["VisualClozeModel", "preprocessing", "random_components", "synthetic_full_components"]
