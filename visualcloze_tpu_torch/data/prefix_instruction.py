"""Prompt templates and the task registry.

A copy of visualcloze_tpu/data/prefix_instruction.py, kept here so that the port imports
nothing of the JAX package.

Counterpart of the reference's config-as-code task space
(data/prefix_instruction.py:1-1085): per-image-type descriptions, layout /
task / content instruction templates, the condition/style/editing/degradation
type lists, and the Graph200K training (graph200k_task_dicts) and evaluation
(test_task_dicts) registries.

The registry STRUCTURE (keys, image types, sample weights, task composition)
mirrors the reference so datasets and checkpoints interoperate. Template TEXT
comes from a selectable **prompt bank**:

- ``"reference"`` (default): the reference's exact template strings,
  AST-extracted into ``reference_bank.json`` by
  ``scripts/extract_reference_bank.py``. The released 384/512 LoRAs were
  trained on exactly these strings, so evaluation (sample.py) and
  released-weight serving must use them — an original paraphrase feeds the
  model out-of-distribution prompts and breaks the PSNR-vs-reference
  protocol. With the same ``random.Random`` state, the draw sequence is
  bit-identical to the reference's (same list lengths, same choice order).
- ``"original"``: this repo's own template bank (same variety, original
  text) — for training new models from scratch on a fresh prompt
  distribution.

Select globally via ``set_prompt_bank()`` / ``$VC_PROMPT_BANK``, or per call
via the ``bank=`` keyword on the four template getters.
"""

from __future__ import annotations

import functools
import json
import os
import random
from pathlib import Path

# ----------------------------- type lists -----------------------------

condition_list = [
    "canny", "depth", "hed", "normal", "mlsd", "openpose", "sam2_mask",
    "mask", "foreground", "background", "uniformer",
]

# ordering used inside the task registries (ref :736-747 — uniformer sits
# before mask there, unlike condition_list)
_TASK_CONDS = [
    "canny", "depth", "hed", "normal", "mlsd", "openpose", "sam2_mask",
    "uniformer", "mask", "foreground", "background",
]

style_list = ["InstantStyle", "ReduxStyle"]

editing_list = ["DepthEdit", "FillEdit"]

# Key-for-key the reference's restoration task space
# (ref data/prefix_instruction.py:6-51) so Graph200K runs are reproducible.
degradation_list = [
    # blur
    "blur",
    "compression",
    "SRx2",
    "SRx4",
    "pixelate",
    "Defocus",
    "GaussianBlur",
    # sharpen
    "oversharpen",
    # noise
    "GaussianNoise",
    "PoissonNoise",
    "SPNoise",
    # mosaic
    "mosaic",
    # contrast
    "contrast_strengthen",
    "contrast_weaken",
    # quantization
    "quantization",
    "JPEG",
    # light
    "brighten",
    "darken",
    "LowLight",
    # color
    "saturate_strengthen",
    "saturate_weaken",
    "gray",
    "ColorDistortion",
    # infilling
    "Inpainting",
    # rotate
    "rotate90",
    "rotate180",
    "rotate270",
    # other
    "Barrel",
    "Pincushion",
    "Elastic",
    # spacial effect
    "Rain",
    "Frost",
]


# ----------------------------- template banks -----------------------------

_IMAGE_PROMPTS: dict[str, list[str]] = {
    "target": [
        "a high-quality photograph",
        "the clean reference photo",
        "an aesthetically pleasing image",
        "a sharp, well-exposed picture",
        "the original full-color image",
        "a detailed, artifact-free photograph",
        "a crisp image with natural colors",
        "a professionally captured photo",
        "an unedited high-resolution picture",
        "a visually rich, well-composed image",
    ],
    "reference": [
        "a reference image of the same subject",
        "an image showing the identical object in another scene",
        "a photo depicting the same item elsewhere",
        "another view of the same subject",
        "the subject photographed in a different setting",
        "a second picture featuring the identical object",
        "an alternate capture of the same entity",
        "the same subject under different conditions",
        "a companion photo of the identical item",
        "an additional exemplar of the subject",
    ],
    "canny": [
        "a canny edge map of the image",
        "white edge contours on a black background",
        "an edge-detection sketch of the scene",
        "thin white outlines tracing every boundary",
        "a binary contour drawing extracted from the photo",
        "the scene reduced to its canny edges",
        "a black canvas with white detected edges",
        "an edge skeleton highlighting object silhouettes",
        "a line rendering from gradient-based edge detection",
        "the picture's structural edges in white on black",
    ],
    "depth": [
        "a depth map of the scene",
        "a grayscale map where brightness encodes distance",
        "a per-pixel depth estimation result",
        "a monochrome rendering of scene geometry by distance",
        "near-to-far structure shown as light-to-dark shading",
        "an estimated depth field of the photograph",
        "a smooth grayscale surface encoding camera distance",
        "the scene's 3D layout visualized as a depth image",
        "a range map computed from the photo",
        "a distance-coded grayscale visualization",
    ],
    "hed": [
        "a holistically-nested edge map",
        "a soft edge drawing of the image",
        "smooth, thick contour strokes of the scene",
        "a soft-boundary sketch from nested edge detection",
        "fuzzy white object outlines on a dark field",
        "a perceptual edge map with gradual strokes",
        "the picture's soft contours rendered in white",
        "an HED boundary drawing of the photograph",
        "blurred-stroke outlines of all major shapes",
        "a soft-edged structural sketch",
    ],
    "normal": [
        "a surface normal map",
        "an RGB-encoded normal estimation of the scene",
        "surface orientations painted in purple, green and blue",
        "a normal-vector visualization of scene geometry",
        "per-pixel surface directions as RGB colors",
        "a colorful rendering of surface slopes",
        "the geometry's facing directions encoded in color",
        "an estimated normal field of the photo",
        "a smooth RGB map of surface orientation",
        "scene surfaces color-coded by their normals",
    ],
    "mlsd": [
        "a wireframe of straight line segments",
        "an M-LSD line segment detection map",
        "white straight lines marking architectural edges",
        "a sparse line drawing of straight structures",
        "detected line segments on a black background",
        "the scene's straight boundaries as thin strokes",
        "a geometric wireframe from line detection",
        "only the straight edges of the picture",
        "a segment map of walls, frames and edges",
        "a minimalist straight-line sketch",
    ],
    "openpose": [
        "a human pose skeleton rendering",
        "an openpose keypoint diagram",
        "colored bones and joints over a black canvas",
        "a stick-figure skeleton of the person's pose",
        "body keypoints connected by colored limbs",
        "the subject's posture as a pose graph",
        "a skeletal pose map with joint markers",
        "an articulated body-landmark drawing",
        "limb segments drawn in rainbow colors",
        "a pose-estimation overlay on black",
    ],
    "sam2_mask": [
        "a colorful SAM2 segmentation of all regions",
        "an automatic everything-mask segmentation",
        "the scene partitioned into vivid colored segments",
        "a patchwork of region masks in bright colors",
        "instance regions filled with distinct hues",
        "a segment-anything mask mosaic",
        "every object region painted a different color",
        "an automatic region decomposition of the photo",
        "a dense segmentation quilt of the scene",
        "color-coded masks covering the whole image",
    ],
    "uniformer": [
        "a semantic segmentation map",
        "a palette-colored semantic parsing of the scene",
        "category regions filled with flat colors",
        "a class-label painting of the photograph",
        "semantic regions in a fixed color palette",
        "the scene labeled by object category colors",
        "a flat-color semantic layout of the image",
        "pixel-level class regions rendered as colors",
        "a segmentation where each color is a category",
        "a semantic region map of the picture",
    ],
    "mask": [
        "the image with a random region masked out",
        "a partially occluded copy of the image",
        "the photo with a blanked-out patch",
        "an image where part of the content is hidden",
        "the picture with an erased rectangular region",
        "a masked variant missing some pixels",
        "the scene with a covered area awaiting fill-in",
        "an incomplete image with a cut-out hole",
        "the photo with one region removed",
        "a copy of the image containing a void region",
    ],
    "foreground": [
        "the extracted foreground subject on a plain backdrop",
        "the salient object cut out from its background",
        "only the main subject, background removed",
        "a clean cut-out of the central object",
        "the subject isolated against black",
        "a matte extraction of the foreground",
        "the primary object segmented from its scene",
        "the focal subject with surroundings blanked",
        "an isolated-subject rendering of the photo",
        "the main entity lifted off its background",
    ],
    "background": [
        "the background with the subject removed",
        "the scene with the main object erased",
        "only the surroundings, subject blanked out",
        "the environment left after cutting the subject",
        "a backdrop plate missing the focal object",
        "the setting with a subject-shaped hole",
        "the scene minus its central entity",
        "an empty-stage version of the photo",
        "the photo's environment without the subject",
        "the residual background after extraction",
    ],
    # style types expand into two columns: the style source swatch and the
    # stylized content image (ref :676-677 returns one prompt for each)
    "style_source": [
        "an image that defines the artistic style to imitate",
        "a swatch carrying the palette and brushwork of the style",
        "the style exemplar whose look should be borrowed",
        "a sample artwork establishing the target aesthetic",
        "the visual style donor image",
        "an exemplar of the desired rendering style",
        "a reference painting supplying the style",
        "the stylistic template to transfer from",
        "an artwork whose technique should be copied",
        "the source of the artistic treatment",
    ],
    "style_target": [
        "an image rendered in that distinctive artistic style",
        "a stylized variant sharing the palette of its style pair",
        "the content re-imagined with the exemplar's style",
        "the photo repainted in the reference style",
        "a style-transferred rendition of the content",
        "the scene redrawn with the borrowed aesthetic",
        "the same content wearing the donor style",
        "an artistic re-rendering matching the style swatch",
        "the image transformed to the exemplar's look",
        "a restyled version following the style source",
    ],
    "DepthEdit": [
        "a new image generated from the depth layout",
        "a depth-guided re-synthesis of the scene",
        "different content placed on the same 3D structure",
        "a re-imagined scene preserving the depth geometry",
        "fresh appearance over the original depth skeleton",
        "the layout kept, the content replaced via depth",
        "a depth-conditioned variation of the picture",
        "new textures painted onto the old geometry",
        "a structure-preserving content edit",
        "an alternate scene sharing the depth map",
    ],
    "FillEdit": [
        "an edited image with new content filled into the masked region",
        "the image after inpainting-based object replacement",
        "the photo with one object swapped via infilling",
        "a locally edited picture with replaced content",
        "the scene with a region regenerated anew",
        "an object-substituted version of the image",
        "the picture after a masked-region rewrite",
        "a fill-in edit placing something new in the hole",
        "the image with an inpainted replacement object",
        "a seamless local edit of the original photo",
    ],
}


# per-degradation descriptions: (noun phrase, effect clause). Composed with
# the sentence frames below into 10 variants per type (the reference bank
# hand-writes ~10 lines per degradation, ref :54-682; same variety, original
# text, one fact source per type).
_DEGRADATION_DESC: dict[str, tuple[str, str]] = {
    "blur": ("a blurred photograph", "softened by a blur that smears fine detail"),
    "compression": ("a compression-damaged image", "scarred by blocky compression artifacts"),
    "SRx2": ("a half-resolution upsample", "softened by 2x downsampling and re-enlargement"),
    "SRx4": ("a quarter-resolution upsample", "heavily softened by 4x down-up resampling"),
    "pixelate": ("a pixelated image", "coarsened into large square pixels"),
    "Defocus": ("a defocused photo", "out of focus with disc-shaped bokeh blur"),
    "GaussianBlur": ("a gaussian-blurred image", "smoothed by a wide gaussian kernel"),
    "oversharpen": ("an oversharpened picture", "ringed by halos from excessive sharpening"),
    "GaussianNoise": ("a noisy photograph", "speckled with gaussian sensor noise"),
    "PoissonNoise": ("a photon-noise image", "grainy with signal-dependent poisson noise"),
    "SPNoise": ("a salt-and-pepper image", "peppered with black and white impulse dots"),
    "mosaic": ("a bayer-mosaic image", "reduced to a raw color-filter mosaic"),
    "contrast_strengthen": ("a high-contrast image", "pushed to exaggerated contrast"),
    "contrast_weaken": ("a low-contrast image", "washed out by flattened contrast"),
    "quantization": ("a color-quantized image", "banded by reduced color levels"),
    "JPEG": ("a JPEG-compressed photo", "marred by 8x8 block JPEG artifacts"),
    "brighten": ("an overbrightened image", "washed toward white by excess brightness"),
    "darken": ("an underexposed image", "sunk into shadow by darkening"),
    "LowLight": ("a low-light photo", "dim and noisy as if shot in near darkness"),
    "saturate_strengthen": ("an oversaturated image", "glowing with exaggerated color saturation"),
    "saturate_weaken": ("a desaturated image", "drained of color toward gray"),
    "gray": ("a grayscale image", "converted to pure monochrome"),
    "ColorDistortion": ("a color-distorted image", "with channels swapped or clipped oddly"),
    "Inpainting": ("a scribbled-over image", "defaced by thick strokes that hide content"),
    "rotate90": ("a 90-degree-rotated image", "turned a quarter-turn clockwise"),
    "rotate180": ("an upside-down image", "rotated a half turn"),
    "rotate270": ("a 270-degree-rotated image", "turned a quarter-turn counter-clockwise"),
    "Barrel": ("a barrel-distorted image", "bulging outward from lens distortion"),
    "Pincushion": ("a pincushion-distorted image", "pinched inward at the center"),
    "Elastic": ("an elastically warped image", "wobbled by rubber-sheet deformation"),
    "Rain": ("a rain-streaked photo", "veiled by diagonal rain streaks"),
    "Frost": ("a frosted image", "clouded by icy frost patterns"),
}


def _degradation_prompt(deg: str) -> list[str]:
    noun, clause = _DEGRADATION_DESC.get(
        deg, (f"an image degraded by {deg}", f"altered by the {deg} degradation")
    )
    return [
        noun,
        f"an image {clause}",
        f"a photo {clause}",
        f"a degraded copy of the original, {clause}",
        f"the same scene but {clause}",
        f"{noun} derived from the clean picture",
        f"a corrupted rendition, {clause}",
        f"the photograph {clause}",
        f"{noun} that needs restoration",
        f"a low-quality version, {clause}",
    ]


# ----------------------------- prompt banks -----------------------------

PROMPT_BANKS = ("reference", "original")

_REFERENCE_BANK_PATH = Path(__file__).with_name("reference_bank.json")


@functools.lru_cache(maxsize=1)
def _reference_bank() -> dict:
    """The reference's exact template tables (see module docstring)."""
    with open(_REFERENCE_BANK_PATH) as f:
        return json.load(f)


def set_prompt_bank(name: str) -> None:
    """Select the global prompt bank ('reference' or 'original')."""
    global _active_bank
    if name not in PROMPT_BANKS:
        raise ValueError(f"unknown prompt bank {name!r}; expected one of {PROMPT_BANKS}")
    _active_bank = name


# Validate the env override at import so a typo'd VC_PROMPT_BANK fails at
# process start, not at the first template draw deep inside a training run.
_active_bank = "reference"
set_prompt_bank(os.environ.get("VC_PROMPT_BANK", "reference"))


def get_prompt_bank() -> str:
    return _active_bank


def _resolve_bank(bank: str | None) -> str:
    bank = bank if bank is not None else _active_bank
    if bank not in PROMPT_BANKS:
        raise ValueError(f"unknown prompt bank {bank!r}; expected one of {PROMPT_BANKS}")
    return bank


def get_image_prompt(image_type: str, rng=random, bank: str | None = None) -> list[str]:
    """One randomly chosen prompt per column the type produces (ref :676-681):
    style types yield [style-source prompt, style-target prompt]; every other
    type yields a single-element list. rng: any random.Random-like source."""
    if image_type in style_list:
        return [
            rng.choice(get_image_prompt_variants("style_source", bank=bank)),
            rng.choice(get_image_prompt_variants("style_target", bank=bank)),
        ]
    return [rng.choice(get_image_prompt_variants(image_type, bank=bank))]


def get_image_prompt_variants(image_type: str, bank: str | None = None) -> list[str]:
    """All template variants for one (single-column) image type (ref :54-682)."""
    if _resolve_bank(bank) == "reference":
        variants = _reference_bank()["image_prompts"].get(image_type)
        if variants is None:
            raise KeyError(f"unknown image type {image_type!r}")
        return variants
    if image_type in _IMAGE_PROMPTS:
        return _IMAGE_PROMPTS[image_type]
    if image_type in degradation_list:
        return _degradation_prompt(image_type)
    raise KeyError(f"unknown image type {image_type!r}")


def get_layout_instruction(cols: int, rows: int, rng=random, bank: str | None = None) -> str:
    """Randomized grid-layout prompt (ref :684-697). In reference-bank mode the
    rendered string AND the rng consumption (one choice from a 10-list) are
    bit-identical to the reference's draw."""
    if _resolve_bank(bank) == "reference":
        tpl = rng.choice(_reference_bank()["layout_templates"])
        return tpl.format(rows=rows, cols=cols, total=cols * rows)
    templates = [
        "A grid layout with {rows} rows and {cols} columns, displaying {total} images arranged side by side.",
        "{total} images are organized into a grid of {rows} rows and {cols} columns, evenly spaced.",
        "An image grid of {rows} by {cols}, containing {total} sub-images in a regular arrangement.",
        "The picture is split into {rows} rows and {cols} columns, {total} tiles in total.",
        "A composite of {total} images laid out in {rows} rows and {cols} columns.",
        "Arranged as {rows}x{cols}, the canvas holds {total} individual images.",
        "This composition shows {total} panels in a {rows}-row, {cols}-column grid.",
        "A tiled sheet with {rows} horizontal bands and {cols} vertical slots, {total} images overall.",
        "The frame contains a {rows}x{cols} matrix of {total} images.",
        "{total} sub-pictures fill a grid that is {rows} rows tall and {cols} columns wide.",
    ]
    return rng.choice(templates).format(rows=rows, cols=cols, total=rows * cols)


def get_task_instruction(
    condition_prompt: str, target_prompt: str, rng=random, bank: str | None = None
) -> str:
    """Randomized in-context task prompt (ref :700-713)."""
    if _resolve_bank(bank) == "reference":
        tpl = rng.choice(_reference_bank()["task_templates"])
        return tpl.format(condition_prompt=condition_prompt, target_prompt=target_prompt)
    templates = [
        "In each row, a logical procedure derives the right-most image from the left: from <{c}> to <{t}>.",
        "Every row demonstrates the same transformation, mapping <{c}> to <{t}>.",
        "Each row applies one rule: the inputs are <{c}> and the output is <{t}>.",
        "Rows share a common mapping whose source is <{c}> and whose result is <{t}>.",
        "Following the in-context examples, <{c}> on the left produces <{t}> on the right.",
        "The right-most image of every row is obtained from the others: <{c}> becomes <{t}>.",
        "A consistent process turns <{c}> into <{t}> across all rows.",
        "Use the pattern of the demonstration rows: given <{c}>, generate <{t}>.",
        "All rows obey one rule that converts <{c}> into <{t}>.",
        "The transformation illustrated row by row maps <{c}> onto <{t}>.",
    ]
    return rng.choice(templates).format(c=condition_prompt, t=target_prompt)


def get_content_instruction(rng=random, bank: str | None = None) -> str:
    """Randomized content-prompt prefix (ref :716-729). The upsampling stage
    strips exactly these prefixes (pipeline/visualcloze.CONTENT_INSTRUCTIONS)."""
    if _resolve_bank(bank) == "reference":
        return rng.choice(_reference_bank()["content_templates"])
    prefixes = [
        "The content of the last image in the final row is: ",
        "The last image of the last row depicts: ",
        "In the final row, the last image shows: ",
        "The last image in the bottom row illustrates: ",
        "The content of the bottom-right image is: ",
        "The final image in the last row portrays: ",
        "The last image of the final row displays: ",
        "In the last row, the final image captures: ",
        "The bottom-right corner image presents: ",
        "The content of the last image in the concluding row is: ",
    ]
    return rng.choice(prefixes)


# ----------------------------- task registries -----------------------------
# Row specs are key-for-key the reference's (ref data/prefix_instruction.py:
# 732-971 train, 974-1085 test) so a reference Graph200K run reproduces here:
# same 12 train / 11 test groups, same image_list compositions and weights.
# Style types occupy the LAST slot of their rows — they expand to two columns
# (style source, stylized target), making the stylized image the target cell.

# conditions that support a given composition family (exact reference subsets)
_COND_WITH_REF = [c for c in _TASK_CONDS if c != "foreground"]  # ref :754-764
_COND_WITH_STYLE = _TASK_CONDS[:9]  # canny..uniformer, mask (ref :771-789)
_DENSE_CONDS = _TASK_CONDS[:8]  # canny..uniformer (ref :850-857)

graph200k_task_dicts: list[dict] = [
    {
        "task_name": "conditional generation",
        "sample_weight": 1,
        "image_list": [[c, "target"] for c in _TASK_CONDS],
    },
    {
        "task_name": "conditional generation with reference",
        "sample_weight": 1,
        "image_list": [["reference", c, "target"] for c in _COND_WITH_REF],
    },
    {
        "task_name": "conditional generation with style",
        "sample_weight": 1,
        "image_list": [[c, "InstantStyle"] for c in _COND_WITH_STYLE]
        + [[c, "ReduxStyle"] for c in _COND_WITH_STYLE],
    },
    {
        "task_name": "image generation with reference",
        "sample_weight": 1,
        "image_list": [["reference", "target"]],
    },
    {
        "task_name": "subject extraction",
        "sample_weight": 1,
        "image_list": [["target", "reference"]],
    },
    {
        "task_name": "style transfer",
        "sample_weight": 1,
        "image_list": [
            ["target", "InstantStyle"],
            ["target", "ReduxStyle"],
            ["reference", "InstantStyle"],
        ],
    },
    {
        "task_name": "style transfer with condition",
        "sample_weight": 1,
        "image_list": [["reference", c, "InstantStyle"] for c in _COND_WITH_STYLE],
    },
    {
        "task_name": "image editing",
        "sample_weight": 1,
        "image_list": [[e, "target"] for e in editing_list],
    },
    {
        "task_name": "image editing with reference",
        "sample_weight": 1,
        "image_list": [["reference", e, "target"] for e in editing_list],
    },
    {
        "task_name": "dense prediction",
        "sample_weight": 1,
        "image_list": [["target", c] for c in _DENSE_CONDS],
    },
    {
        "task_name": "restoration",
        "sample_weight": 1,
        "image_list": [[deg, "target"] for deg in degradation_list],
    },
    {
        "task_name": "restoration with reference",
        "sample_weight": 1,
        "image_list": [["reference", deg, "target"] for deg in degradation_list],
    },
]

test_task_dicts: list[dict] = [
    {
        "task_name": "conditional generation",
        "sample_weight": 1,
        "image_list": [[c, "target"] for c in _TASK_CONDS],
    },
    {
        "task_name": "image generation with reference",
        "sample_weight": 1,
        "image_list": [["reference", "target"]],
    },
    {
        "task_name": "conditional generation with reference",
        "sample_weight": 1,
        "image_list": [
            ["reference", "depth", "target"],
            ["reference", "openpose", "target"],
        ],
    },
    {
        "task_name": "subject extraction",
        "sample_weight": 0.2,
        "image_list": [["target", "reference"]],
    },
    {
        "task_name": "dense prediction",
        "sample_weight": 1,
        "image_list": [["target", "depth"], ["target", "openpose"]],
    },
    {
        "task_name": "restoration",
        "sample_weight": 1,
        "image_list": [
            ["GaussianBlur", "target"],
            ["Inpainting", "target"],
            ["rotate90", "target"],
            ["Elastic", "target"],
        ],
    },
    {
        "task_name": "restoration with reference",
        "sample_weight": 1,
        "image_list": [["reference", "Inpainting", "target"]],
    },
    {
        "task_name": "image editing with reference",
        "sample_weight": 1,
        "image_list": [
            ["reference", "DepthEdit", "target"],
            ["reference", "FillEdit", "target"],
        ],
    },
    {
        "task_name": "style transfer",
        "sample_weight": 1,
        "image_list": [
            ["target", "InstantStyle"],
            ["target", "ReduxStyle"],
            ["reference", "InstantStyle"],
        ],
    },
    {
        "task_name": "style transfer with condition",
        "sample_weight": 1,
        "image_list": [["reference", c, "InstantStyle"] for c in _COND_WITH_STYLE],
    },
    {
        # reference-faithful duplicate of the 0.2-weight group above
        # (ref :1079-1085 repeats it at weight 1; sample.py's id-dedup then
        # skips the repeat — same behavior as the reference sweep)
        "task_name": "subject extraction",
        "sample_weight": 1,
        "image_list": [["target", "reference"]],
    },
]
