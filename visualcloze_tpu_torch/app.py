"""Gradio web demo of the port (counterpart of the root app.py).

    python -m visualcloze_tpu_torch.app --demo [--device cpu] [--port 7860]

A grid of up to 5x5 cells with three prompt boxes (the layout filled in from
the grid's shape), the sampling options, the task-family example galleries
(gradio_tasks.py, over examples/assets/), and the generate flow of the
inference CLI. Gradio is optional: without it, main() stops with a clear
error. The model is built as the inference CLI builds it: --demo is random
weights (full width on the card, tiny on the CPU), else checkpoint files.
"""

from __future__ import annotations

import argparse

from .device import resolve_device
from .pipeline import build_visualcloze, random_components

MAX_GRID = 5

DEFAULTS = dict(seed=0, cfg=30.0, steps=30, upsampling_steps=10, upsampling_noise=0.4)


def build_model(args):
    import torch

    device = resolve_device(args.device)
    full = device.type == "cuda"
    if args.demo:
        return random_components(tiny=not full, dtype=torch.bfloat16 if full else torch.float32, device=device,
                                 resolution=384 if full else 64)
    return build_visualcloze(
        model_path=args.model_path, model_name=args.model_name, lora_rank=args.lora_rank,
        resolution=args.resolution, device=device, dtype=torch.bfloat16 if full else torch.float32,
    )


def layout_prompt(rows: int, cols: int) -> str:
    return (
        f"A grid layout with {rows} rows and {cols} columns, "
        f"displaying {rows * cols} images arranged side by side."
    )


def generate(model, grid_h, grid_w, images, layout, task, content,
             seed, cfg, steps, upsampling_steps, upsampling_noise, is_upsampling):
    grid = []
    for i in range(int(grid_h)):
        row = []
        for j in range(int(grid_w)):
            row.append(images[i * MAX_GRID + j])
        grid.append(row)
    model.set_grid_size(int(grid_h), int(grid_w))
    outs = model.process_images(
        grid, [layout, task, content],
        seed=int(seed), cfg=float(cfg), steps=int(steps),
        upsampling_steps=int(upsampling_steps),
        upsampling_noise=float(upsampling_noise),
        is_upsampling=bool(is_upsampling),
    )
    return outs[0] if outs else None


def gallery_entries() -> dict[str, list]:
    """Per-family (thumbnail path, example) lists for the demo's 16
    galleries; gradio-free, so that tests can check them without the UI."""
    from .gradio_tasks import refresh_task_families

    families = refresh_task_families()
    out = {}
    for family, examples in families.items():
        entries = []
        for ex in examples:
            row = ex.rows(context_num=1)[0]
            thumb = next((c for c in row if c), None)
            if thumb:
                entries.append((thumb, ex))
        if entries:
            out[family] = entries
    return out


def apply_example_outputs(example, context_num: int = 1):
    """process_tasks output -> values for the UI components:
    [grid_h, grid_w, layout, task, content, upsampling_noise, steps,
    *25 cell values (None where hidden/masked)]."""
    from PIL import Image as PILImage

    from .gradio_tasks import process_tasks

    out = process_tasks(example, context_num)
    _mask_count, gh, gw, layout_v, task_v, content_v, noise_v, steps_v = out[:8]
    images = out[8:]
    cells: list = [None] * (MAX_GRID * MAX_GRID)
    for r in range(gh):
        for c in range(gw):
            path = images[r * gw + c]
            cells[r * MAX_GRID + c] = PILImage.open(path) if path else None
    return [gh, gw, layout_v, task_v, content_v, noise_v, steps_v, *cells]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_name", default="flux-dev-fill-lora")
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--lora_rank", type=int, default=256)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; install it to run the web demo, or use "
            "python -m visualcloze_tpu_torch.inference / .sample / .serve"
        ) from e

    model = build_model(args)
    demo = build_ui(gr, model)
    demo.launch(server_port=args.port)


def build_ui(gr, model):
    """The gr.Blocks graph, not launched (main() launches it; tests build
    it against a stub gradio)."""
    with gr.Blocks(title="VisualCloze") as demo:
        gr.Markdown("# VisualCloze\nVisual in-context learning: "
                    "fill the grid with demonstration rows, leave the target cell empty.")
        with gr.Row():
            grid_h = gr.Slider(1, MAX_GRID, value=2, step=1, label="Rows")
            grid_w = gr.Slider(1, MAX_GRID, value=2, step=1, label="Columns")
        cells = []
        for i in range(MAX_GRID):
            with gr.Row():
                for j in range(MAX_GRID):
                    cells.append(gr.Image(type="pil", label=f"({i + 1},{j + 1})", visible=i < 2 and j < 2))

        def update_grid(h, w):
            return [gr.update(visible=(i // MAX_GRID) < h and (i % MAX_GRID) < w)
                    for i in range(MAX_GRID * MAX_GRID)]

        grid_h.change(update_grid, [grid_h, grid_w], cells)
        grid_w.change(update_grid, [grid_h, grid_w], cells)

        layout = gr.Textbox(label="Layout prompt", value=layout_prompt(2, 2))
        grid_h.change(lambda h, w: layout_prompt(int(h), int(w)), [grid_h, grid_w], layout)
        grid_w.change(lambda h, w: layout_prompt(int(h), int(w)), [grid_h, grid_w], layout)
        task = gr.Textbox(label="Task prompt")
        content = gr.Textbox(label="Content prompt")
        with gr.Accordion("Advanced options", open=False):
            seed = gr.Number(value=DEFAULTS["seed"], label="Seed (0 = random)")
            cfg = gr.Slider(1.0, 50.0, value=DEFAULTS["cfg"], label="Guidance")
            steps = gr.Slider(1, 100, value=DEFAULTS["steps"], step=1, label="Steps")
            upsampling_steps = gr.Slider(1, 50, value=DEFAULTS["upsampling_steps"], step=1,
                                         label="Upsampling steps")
            upsampling_noise = gr.Slider(0.0, 1.0, value=DEFAULTS["upsampling_noise"],
                                         label="Upsampling noise (1 = off)")
            is_upsampling = gr.Checkbox(value=True, label="SDEdit upsampling")
        btn = gr.Button("Generate", variant="primary")
        output = gr.Image(label="Result")

        # the task-family example galleries
        example_targets = [grid_h, grid_w, layout, task, content,
                           upsampling_noise, steps, *cells]
        with gr.Accordion("Task examples", open=True):
            for family, entries in gallery_entries().items():
                with gr.Tab(family.replace("_", " ")):
                    gallery = gr.Gallery(
                        value=[(thumb, ex.name) for thumb, ex in entries],
                        columns=4, height=140, label=family,
                    )

                    def on_select(evt: gr.SelectData, entries=entries):
                        _, ex = entries[evt.index]
                        return apply_example_outputs(ex)

                    gallery.select(on_select, None, example_targets)

        def on_click(h, w, *rest):
            n = MAX_GRID * MAX_GRID
            images = list(rest[:n])
            (layout_v, task_v, content_v, seed_v, cfg_v, steps_v,
             us_v, un_v, isu_v) = rest[n:]
            return generate(model, h, w, images, layout_v, task_v, content_v,
                            seed_v, cfg_v, steps_v, us_v, un_v, isu_v)

        btn.click(
            on_click,
            [grid_h, grid_w, *cells, layout, task, content, seed, cfg, steps,
             upsampling_steps, upsampling_noise, is_upsampling],
            output,
        )

    return demo


if __name__ == "__main__":
    main()
