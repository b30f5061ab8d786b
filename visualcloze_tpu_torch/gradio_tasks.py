"""Example galleries of the port's Gradio demo (a copy of
examples/gradio_tasks.py on the port's data/prefix_instruction.py, kept here
because the root examples package imports the JAX package).

A path convention (`generate_paths_from_id`), per-family example
registries, and `process_tasks`, which returns the demo's output signature.
The asset files are read as data under $EXAMPLES_ROOT (default
examples/assets/ of the checkout); families with missing assets yield empty
galleries instead of failing.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

from .data.prefix_instruction import (
    get_content_instruction,
    get_image_prompt,
    get_layout_instruction,
    get_task_instruction,
)

EXAMPLES_ROOT = os.environ.get(
    "EXAMPLES_ROOT", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "assets"))


def asset_path(file_id: str, image_type: str) -> str:
    """Path convention: <EXAMPLES_ROOT>/<id>_<type>.jpg — ANY image type
    (conditions, degradations, editing variants) resolves uniformly."""
    return os.path.join(EXAMPLES_ROOT, f"{file_id}_{image_type}.jpg")


_KNOWN_TYPES = (
    "target", "canny", "depth", "hed", "normal", "mlsd", "openpose",
    "sam2_mask", "uniformer", "foreground", "background", "mask",
    "reference", "style_source", "style_target",
)


class _AssetPaths(dict):
    """dict of modality -> path that also resolves unknown image types (e.g.
    degradation names, DepthEdit) through the same naming convention.

    get() is existence-checked: it returns the conventional path only when
    the file is actually on disk, else the caller's default — so galleries
    degrade to empty/None cells instead of fabricating dead paths."""

    def __init__(self, file_id: str, prompt: str):
        super().__init__({t: asset_path(file_id, t) for t in _KNOWN_TYPES})
        self["prompt"] = prompt
        self._file_id = file_id

    def get(self, key, default=None):  # noqa: A003 - dict API
        if key == "prompt":
            return super().get(key, default)
        path = super().get(key) or asset_path(self._file_id, key)
        return path if os.path.exists(path) else default


def generate_paths_from_id(file_id: str, prompt: str) -> dict[str, str]:
    """One asset id maps to every condition modality
    (ref examples/gradio_tasks.py:8-36)."""
    return _AssetPaths(file_id, prompt)


@dataclass
class TaskExample:
    name: str
    image_type_list: list[str]
    file_ids: list[str]
    prompts: list[str]
    mask_count: int = 1

    def rows(self, context_num: int = 1) -> list[list[str | None]]:
        """Grid of asset paths; the final row's last `mask_count` cells are
        None (masked)."""
        grid: list[list[str | None]] = []
        for i, fid in enumerate(self.file_ids[: context_num + 1]):
            paths = generate_paths_from_id(fid, self.prompts[min(i, len(self.prompts) - 1)])
            row: list[str | None] = [paths.get(t) for t in self.image_type_list]
            grid.append(row)
        for j in range(1, self.mask_count + 1):
            grid[-1][-j] = None
        return grid


task_families: dict[str, list[TaskExample]] = {}
_FAMILY_DEFS: dict[str, list[TaskExample]] = {}


def _available(examples: list[TaskExample]) -> list[TaskExample]:
    """Keep only examples whose EVERY non-masked grid cell exists on disk
    (a partially-written asset pack must not surface dead gallery entries).
    rows() yields None for the masked tail cells and — via the
    existence-checked get() — for any missing asset file."""
    out = []
    for ex in examples:
        cells = [c for row in ex.rows(context_num=1) for c in row]
        if all(c is not None for c in cells[: len(cells) - ex.mask_count]):
            out.append(ex)
    return out


def register_task_family(family: str, examples: list[TaskExample]) -> None:
    _FAMILY_DEFS[family] = examples
    task_families[family] = _available(examples)


def refresh_task_families() -> dict[str, list[TaskExample]]:
    """Re-filter every family against the assets currently on disk (call
    after examples.make_assets writes the pack)."""
    for family, examples in _FAMILY_DEFS.items():
        task_families[family] = _available(examples)
    return task_families


def dense_prediction_tasks() -> list[TaskExample]:
    conds = ("canny", "depth", "hed", "normal", "openpose", "uniformer")
    ids = [["dense_0", "dense_1"], ["dense_2", "dense_3"], ["dense_1", "dense_2"],
           ["dense_3", "dense_0"], ["dense_0", "dense_2"], ["dense_1", "dense_3"]]
    return [
        TaskExample(
            name=f"image to {cond}",
            image_type_list=["target", cond],
            file_ids=pair,
            prompts=["a photo", f"the {cond} map of the photo"],
        )
        for cond, pair in zip(conds, ids)
    ]


def conditional_generation_tasks() -> list[TaskExample]:
    conds = ("canny", "depth", "mlsd", "normal", "sam2_mask")
    ids = [["cond_0", "cond_1"], ["cond_2", "cond_3"], ["cond_1", "cond_2"],
           ["cond_3", "cond_0"], ["cond_0", "cond_2"]]
    return [
        TaskExample(
            name=f"{cond} to image",
            image_type_list=[cond, "target"],
            file_ids=pair,
            prompts=["a photo", f"a photo synthesized from its {cond} map"],
        )
        for cond, pair in zip(conds, ids)
    ]


register_task_family("dense_prediction", dense_prediction_tasks())
register_task_family("conditional_generation", conditional_generation_tasks())


def process_tasks(example: TaskExample, context_num: int = 1):
    """Build the demo output signature (ref gradio_tasks.py:343-374):
    [mask_count, grid_h, grid_w, layout, task, content, upsampling_noise,
    steps, *image_paths]."""
    grid = example.rows(context_num)
    grid_h, grid_w = len(grid), len(grid[0])
    prompts = [p for t in example.image_type_list for p in get_image_prompt(t)]
    prompts = [f"[IMAGE{i + 1}] {p}" for i, p in enumerate(prompts)]
    layout = get_layout_instruction(grid_w, grid_h)
    task = get_task_instruction(", ".join(prompts[:-1]), prompts[-1])
    content = (
        get_content_instruction() + example.prompts[-1]
        if example.image_type_list[-1] == "target"
        else ""
    )
    images = [cell for row in grid for cell in row]
    return [example.mask_count, grid_h, grid_w, layout, task, content, 0.4, 30, *images]


# ---------------------------------------------------------------------------
# Curated family banks.
#
# Mirrors the reference bank structure (examples/gradio_tasks_relighting.py:
# 9-107 and siblings): each family holds several named example rows drawn
# from a small id pool, each with its own content-prompt phrasing. Assets are
# synthetic (examples/make_assets.py); ids index a 4-scene pool per family
# and examples combine them as 2- or 3-row grids.
# ---------------------------------------------------------------------------

def _pairs(prefix: str) -> list[list[str]]:
    """Curated id combinations over a 4-scene pool: four 2-row grids and two
    3-row (2-context) grids."""
    p = [f"{prefix}_{i}" for i in range(4)]
    return [
        [p[0], p[1]], [p[2], p[3]], [p[1], p[2]], [p[3], p[0]],
        [p[0], p[2], p[3]], [p[1], p[3], p[2]],
    ]


def _bank(
    family_name: str,
    type_list: list[str],
    prefix: str,
    variants: list[str],
    mask_count: int = 1,
) -> list[TaskExample]:
    """One TaskExample per (id combination, content phrasing) pair — 4-6
    curated rows per family, each with family-specific prompt variety."""
    return [
        TaskExample(
            name=f"{family_name}: {variant}",
            image_type_list=type_list,
            file_ids=ids,
            prompts=["a photo"] * (len(ids) - 1) + [variant],
            mask_count=mask_count,
        )
        for ids, variant in zip(_pairs(prefix), variants)
    ]


def restoration_tasks() -> list[TaskExample]:
    degs = ("GaussianNoise", "GaussianBlur", "JPEG", "LowLight", "SRx4", "Inpainting")
    blurbs = {
        "GaussianNoise": "a clean photo recovered from heavy sensor noise",
        "GaussianBlur": "a sharp photo recovered from out-of-focus blur",
        "JPEG": "a clean photo free of blocky compression artifacts",
        "LowLight": "a well-exposed photo recovered from a dark capture",
        "SRx4": "a high-resolution photo restored from a 4x downsampled copy",
        "Inpainting": "a complete photo with the scribbled-out regions filled in",
    }
    return [
        TaskExample(
            name=f"restore {deg}",
            image_type_list=[deg, "target"],
            file_ids=ids,
            prompts=["a photo"] * (len(ids) - 1) + [blurbs[deg]],
        )
        for deg, ids in zip(degs, _pairs("rest"))
    ]


register_task_family("restoration", restoration_tasks())
register_task_family("style_transfer", _bank(
    "style transfer", ["style_source", "style_target"], "style",
    ["a twilight-palette rendition of the scene",
     "an ocean-toned rendition of the scene",
     "a warm autumn-graded rendition of the scene",
     "a soft rose-tinted rendition of the scene",
     "a monochrome film rendition of the scene",
     "a vivid high-saturation rendition of the scene"]))
register_task_family("style_condition", _bank(
    "style transfer with edge guidance", ["canny", "style_source", "style_target"],
    "style",
    ["a stylized scene following the edge map",
     "an ocean-toned scene following the edge map",
     "an autumn-graded scene following the edge map",
     "a rose-tinted scene following the edge map"]))
register_task_family("tryon", _bank(
    "virtual try-on", ["reference", "mask", "target"], "tryon",
    ["a person wearing the garment from the reference image",
     "the model dressed in the referenced outfit",
     "the garment fitted onto the person in the masked region",
     "the outfit transferred onto the subject"]))
register_task_family("relighting", _bank(
    "relighting", ["target", "reference"], "relight",
    ["the scene relit by sunset over the sea",
     "the scene relit with light and shadow from the left",
     "the scene relit in golden-hour light",
     "the scene relit by shadow from a window",
     "the scene relit with soft studio lighting",
     "the scene relit with neon glow"]))
register_task_family("photodoodle", _bank(
    "photo doodle", ["target", "reference"], "doodle",
    ["the photo decorated with hand-drawn hearts",
     "the photo decorated with chalk scribbles",
     "the photo decorated with cartoon monsters",
     "the photo decorated with a flower crown"]))
register_task_family("editing", _bank(
    "depth-guided editing", ["DepthEdit", "target"], "edit",
    ["the scene re-rendered under the edited depth layout",
     "the scene with objects moved per the new depth map",
     "the scene restructured to match the edited geometry",
     "the scene following the adjusted depth arrangement"]))
register_task_family("editing_reference", _bank(
    "editing with reference", ["reference", "FillEdit", "target"], "edit",
    ["the edit region replaced with content from the reference",
     "the masked area filled to match the reference object",
     "the local edit harmonized with the reference image",
     "the filled region blended with the reference style"]))
register_task_family("subject_generation", _bank(
    "subject-driven generation", ["reference", "target"], "subj",
    ["the subject from the reference placed in a new scene",
     "the referenced subject photographed outdoors",
     "the subject recontextualized on a fresh background",
     "the subject rendered in a different setting",
     "the referenced subject under new lighting"]))
register_task_family("subject_condition", _bank(
    "subject-driven generation with depth", ["reference", "depth", "target"], "subj",
    ["the subject posed to match the depth layout",
     "the referenced subject following the depth map",
     "the subject composed per the depth structure",
     "the subject arranged along the given geometry"]))
register_task_family("subject_style", _bank(
    "subject-driven generation with style", ["style_source", "reference", "target"],
    "subj",
    ["the subject painted in the reference style",
     "the referenced subject in a twilight palette",
     "the subject rendered with the style's color grade",
     "the subject restyled to match the style image"]))
register_task_family("subject_extraction", _bank(
    "subject extraction", ["target", "foreground"], "dense",
    ["the subject isolated from the scene",
     "the foreground object cut out cleanly",
     "the main subject extracted on white",
     "the object segmented from its background"]))
register_task_family("image_generation", _bank(
    "reference-guided generation", ["reference", "target"], "cond",
    ["a new photo consistent with the reference scene",
     "a variation of the referenced composition",
     "a fresh scene matching the reference's content",
     "a re-imagined view of the referenced scene"]))
register_task_family("unseen_tasks", _bank(
    "unseen in-context task", ["mask", "target"], "unseen",
    ["an image completed from the mask layout alone",
     "a scene synthesized from the binary mask",
     "an unseen mapping inferred from the context rows",
     "a novel task demonstrated only in-context"]))
