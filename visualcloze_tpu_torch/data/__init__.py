"""Graph200K training data of the port: host-side copies of the JAX
package's data modules (no JAX in them, only the imports changed)."""

from . import prefix_instruction
from .data_reader import Graph200KItemProcessor
from .data_utils import check_item_graph200k, dataloader_collate_fn, get_train_sampler
from .dataset import GridDataset
from .loader import DataLoader

__all__ = [
    "DataLoader", "Graph200KItemProcessor", "GridDataset", "check_item_graph200k",
    "dataloader_collate_fn", "get_train_sampler", "prefix_instruction",
]
