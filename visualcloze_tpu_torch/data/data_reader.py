"""Graph200K record -> grid rows.

A copy of visualcloze_tpu/data/data_reader.py, kept here so that the port imports
nothing of the JAX package.

Counterpart of the reference T2IItemProcessor (data/data_reader.py:58-167):
maps image types to images (direct paths, foreground/background mask
multiply, style pairs, editing variants, on-the-fly degradations), resizes
each cell to a square-ish area (aspect_ratio=1.0), jointly shuffles the
context columns with their prompts, and emits either training rows
(hconcat'd [-1,1] float arrays) or a test grid (PIL) + 3-part instruction.
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image

from ..pipeline.preprocessing import image_to_array, resize_with_aspect_ratio
from .degradations import add_degradation
from .prefix_instruction import (
    condition_list,
    degradation_list,
    editing_list,
    get_content_instruction,
    get_image_prompt,
    get_layout_instruction,
    get_task_instruction,
    style_list,
)


class Graph200KItemProcessor:
    """ItemProcessor for the Graph200K grid task (group
    'image_grid_graph200k')."""

    def __init__(self, resolution: int = 384):
        self.resolution = resolution

    # ------------------------- image-type resolution -------------------------

    def get_image_object200k(
        self, data_item: dict, image_type: str, rng: random.Random = random
    ) -> list[Image.Image]:
        """(ref data/data_reader.py:64-106)."""
        cond = data_item["condition"]
        if image_type in ("target", "reference"):
            return [Image.open(cond[image_type]).convert("RGB")]
        if image_type in ("foreground", "background"):
            target = Image.open(cond["target"]).convert("RGB")
            mask = Image.open(cond["foreground"]).convert("L")
            mask_np = (np.array(mask).astype(np.float32) / 255.0 > 0.5).astype(np.int32)
            if image_type == "background":
                mask_np = 1 - mask_np
            out = (np.array(target) * mask_np[..., None]).astype(np.uint8)
            return [Image.fromarray(out)]
        if image_type in style_list:
            source = cond[image_type]
            idx = rng.randint(0, len(source["style_path"]) - 1)
            style = Image.open(source["style_path"][idx]).convert("RGB")
            target = Image.open(source["image_path"][idx]).convert("RGB")
            return [style, target]
        if image_type in editing_list:
            if image_type == "DepthEdit":
                path = cond["DepthEdit"]
            else:
                path = rng.choice(cond["FillEdit"]["image_path"])
            return [Image.open(path).convert("RGB")]
        if image_type in condition_list:
            return [Image.open(cond[image_type]).convert("RGB")]
        if image_type in degradation_list:
            target = Image.open(cond["target"]).convert("RGB")
            np_rng = np.random.default_rng(rng.getrandbits(63))
            deg = add_degradation(np.array(target), image_type, rng=np_rng)
            return [Image.fromarray(deg)]
        raise NotImplementedError(image_type)

    # ------------------------- grid assembly -------------------------

    def process_item(
        self,
        data_item: list[dict],
        training_mode: bool = False,
        image_type_list: list[str] | None = None,
        context_num: int = 1,
        group_name: str | None = None,
        rng: random.Random = random,
    ):
        """(ref data/data_reader.py:108-167). data_item: one record per row.

        rng: all randomness (style-pair pick, degradation params, template
        choices, column shuffle) draws from this generator; the dataset passes
        a per-(seed, index) instance for deterministic resumable data order.
        """
        image_list: list[list[Image.Image]] = [[] for _ in range(context_num)]
        for i in range(context_num):
            for image_type in image_type_list:
                images = self.get_image_object200k(data_item[i], image_type, rng=rng)
                images = [
                    resize_with_aspect_ratio(img, self.resolution, aspect_ratio=1.0)
                    for img in images
                ]
                image_list[i] += images

        image_prompt_list: list[str] = []
        for image_type in image_type_list:
            image_prompt_list += get_image_prompt(image_type, rng=rng)

        # jointly shuffle the context columns with their prompts (:121-126)
        if training_mode:
            indices = list(range(len(image_prompt_list) - 1))
            rng.shuffle(indices)
            for i in range(context_num):
                image_list[i][: len(image_prompt_list) - 1] = [
                    image_list[i][j] for j in indices
                ]
            image_prompt_list[: len(image_prompt_list) - 1] = [
                image_prompt_list[j] for j in indices
            ]
        image_prompt_list = [
            f"[IMAGE{idx + 1}] {p}" for idx, p in enumerate(image_prompt_list)
        ]

        i = context_num - 1  # the record providing the content description
        if not training_mode:
            condition_prompt = ", ".join(image_prompt_list[:-1])
            target_prompt = image_prompt_list[-1]
            instruction = [
                get_layout_instruction(len(image_list[0]), context_num, rng=rng),
                get_task_instruction(condition_prompt, target_prompt, rng=rng),
            ]
            if image_type_list[-1] == "target":
                instruction.append(
                    get_content_instruction(rng=rng)
                    + data_item[i]["description"]["item"]
                    + " "
                    + data_item[i]["description"]["description_0"]
                )
            else:
                instruction.append("")
            return group_name, image_list, instruction, None, (len(image_list[0]), len(image_list))

        # training: hconcat rows to [-1,1] float arrays (:143-150)
        from ..pipeline.preprocessing import to_rgb_if_rgba

        processed = []
        for images in image_list:
            cells = [np.asarray(to_rgb_if_rgba(img), dtype=np.uint8) for img in images]
            row = np.concatenate(cells, axis=1).astype(np.float32) * (2.0 / 255.0) - 1.0
            processed.append(row)

        instruction = get_layout_instruction(len(image_list[0]), context_num, rng=rng)
        if rng.random() < 0.8:
            condition_prompt = ", ".join(image_prompt_list[:-1])
            target_prompt = image_prompt_list[-1]
            instruction = instruction + " " + get_task_instruction(
                condition_prompt, target_prompt, rng=rng
            )
        if rng.random() < 0.8 and image_type_list[-1] == "target":
            instruction = (
                instruction + " " + get_content_instruction(rng=rng)
                + data_item[i]["description"]["item"] + " "
                + data_item[i]["description"]["description_0"]
            )
        return group_name, processed, instruction, None, (len(image_list[0]), len(image_list))
