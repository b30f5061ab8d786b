"""Dataset utilities: record validation, collation, deterministic sampler.

A copy of visualcloze_tpu/data/data_utils.py, kept here so that the port imports
nothing of the JAX package.

Counterpart of the reference data/data_utils.py:5-58.
"""

from __future__ import annotations

import numpy as np

from .prefix_instruction import degradation_list


def check_item_graph200k(data: dict, image_type_list: list[str]) -> bool:
    """Validate that a Graph200K record supports a row spec
    (ref data/data_utils.py:5-33)."""
    for image_type in image_type_list:
        if image_type in (
            "target", "mask", "bbox",
            "canny", "depth", "hed", "normal", "openpose", "mlsd",
            "sam2_mask", "uniformer",
            "DepthEdit", "FillEdit", "ReduxStyle", "InstantStyle",
        ):
            if image_type not in data["condition"]:
                return False
        elif image_type in ("foreground", "background"):
            if "foreground" not in data["condition"]:
                return False
        elif image_type == "reference":
            qa = data.get("quality_assessment")
            if qa is None or qa.get("objectConsistency", 0) < 3:
                return False
        elif image_type in degradation_list:
            continue
        else:
            raise NotImplementedError(image_type)
    return True


def dataloader_collate_fn(samples):
    """List-of-fields passthrough (ref data/data_utils.py:36-42)."""
    group_names = [x[0] for x in samples]
    image = [x[1] for x in samples]
    prompt = [x[2] for x in samples]
    text_emb = [x[3] for x in samples]
    grid_shape = [x[4] for x in samples]
    return group_names, image, prompt, text_emb, grid_shape


def get_train_sampler(
    dataset_len: int,
    rank: int,
    world_size: int,
    global_batch_size: int,
    max_steps: int,
    resume_step: int,
    seed: int,
) -> list[int]:
    """Deterministic resumable rank-strided sampler (ref data/data_utils.py:
    45-58): per-epoch seeded permutations, rank-strided with a drift offset so
    successive epochs rotate which ranks see which residue classes, flattened
    to max_steps worth of indices and sliced at the resume point."""
    total = max_steps * global_batch_size // world_size
    sample_indices = np.empty((total,), dtype=np.int64)
    epoch_id, fill_ptr, offs = 0, 0, 0
    while fill_ptr < total:
        g = np.random.default_rng(seed + epoch_id)
        epoch_indices = g.permutation(dataset_len)
        epoch_id += 1
        epoch_indices = epoch_indices[(rank + offs) % world_size :: world_size]
        offs = (offs + world_size - dataset_len % world_size) % world_size
        epoch_indices = epoch_indices[: total - fill_ptr]
        sample_indices[fill_ptr : fill_ptr + len(epoch_indices)] = epoch_indices
        fill_ptr += len(epoch_indices)
    return sample_indices[resume_step * global_batch_size // world_size :].tolist()
