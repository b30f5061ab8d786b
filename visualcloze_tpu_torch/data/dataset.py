"""GridDataset: task-sampled in-context grids over annotation files.

A copy of visualcloze_tpu/data/dataset.py, kept here so that the port imports
nothing of the JAX package.

Counterpart of the reference MyDataset (data/dataset.py:36-249): YAML data
config (META list of json/jsonl files with type/root/ratio), optional h5
disk cache with a rank-0-writes / others-poll handshake, group-weighted task
sampling, context-count sampling {1,2,3} w.p. [0.3, 0.4, 0.3], and
record-validation retries over in-group indices.

No torch Dataset base class; this is a plain indexable object consumed by
data.loader.DataLoader.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import time
import warnings
from pathlib import Path

from .data_reader import Graph200KItemProcessor
from .data_utils import check_item_graph200k

logger = logging.getLogger(__name__)


class GridDataset:
    def __init__(
        self,
        config_path: str,
        item_processor: Graph200KItemProcessor,
        cache_on_disk: bool = False,
        task_dicts: dict[str, list[dict]] | None = None,
        process_index: int = 0,
        cache_root: str = "./accessory_data_cache",
        seed: int = 0,
    ):
        self.seed = seed
        import yaml  # only here: JSON text is YAML too

        logger.info("read dataset config from %s", config_path)
        with open(config_path) as f:
            self.config = yaml.safe_load(f)
        self.task_dicts = task_dicts or {}
        self.cache_on_disk = cache_on_disk
        self.cache_root = cache_root

        if cache_on_disk:
            cache_dir = self._get_cache_dir(config_path)
            if process_index == 0:
                self._collect_annotations_and_save_to_cache(cache_dir)
            ann, group_indice_range = self._load_annotations_from_cache(cache_dir, process_index)
        else:
            ann, group_indice_range = self._collect_annotations()

        self.ann = ann
        self.group_indices = {
            key: list(range(val[0], val[1])) for key, val in group_indice_range.items()
        }
        self.group_weights = {"image_grid_graph200k": 1.0}
        self.item_processor = item_processor
        self.check_item = {"image_grid_graph200k": self._check_item_graph200k}
        logger.info("total length: %d", len(self))

    def __len__(self) -> int:
        return len(self.ann)

    # ------------------------- annotation loading -------------------------

    def _collect_annotations(self):
        group_ann: dict[str, list] = {}
        for meta in self.config["META"]:
            meta_path, meta_type = meta["path"], meta.get("type", "default")
            ext = os.path.splitext(meta_path)[-1]
            if ext == ".json":
                with open(meta_path) as f:
                    meta_l = json.load(f)
            elif ext == ".jsonl":
                meta_l = []
                with open(meta_path) as f:
                    for i, line in enumerate(f):
                        try:
                            meta_l.append(json.loads(line))
                        except json.JSONDecodeError:
                            logger.error("bad jsonl line %d in %s", i, meta_path)
                            raise
            else:
                raise NotImplementedError(f"unknown meta extension {ext!r}")
            if "ratio" in meta:
                # local Random: same deterministic subsample as seeding the
                # global module with 0, WITHOUT stomping interpreter-global
                # random state as a hidden constructor side effect
                meta_l = random.Random(0).sample(
                    meta_l, int(len(meta_l) * meta["ratio"])
                )
            if "root" in meta:
                for item in meta_l:
                    for path_key in ("path", "image_url", "image", "input_path", "target_path"):
                        if path_key in item:
                            item[path_key] = os.path.join(meta["root"], item[path_key])
                    if "condition" in item:
                        item["condition"] = _prefix_paths(item["condition"], meta["root"])
            group_ann.setdefault(meta_type, []).extend(meta_l)

        ann = sum(group_ann.values(), start=[])
        group_indice_range = {}
        start = 0
        for meta_type, meta_l in group_ann.items():
            group_indice_range[meta_type] = [start, start + len(meta_l)]
            start += len(meta_l)
        return ann, group_indice_range

    def _get_cache_dir(self, config_path: str) -> str:
        ident = config_path
        for ch in ("/", "\\", ".", "?", "!"):
            ident = ident.replace(ch, "-")
        return os.path.join(self.cache_root, ident)

    def _collect_annotations_and_save_to_cache(self, cache_dir: str) -> None:
        import h5py

        if (Path(cache_dir) / "data.h5").exists() and (Path(cache_dir) / "ready").exists():
            warnings.warn(f"Using existing h5 data cache: {cache_dir}")
            return
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        ann, group_indice_range = self._collect_annotations()
        serialized = [json.dumps(x) for x in ann]
        with h5py.File(Path(cache_dir) / "data.h5", "w") as f:
            dt = h5py.vlen_dtype(str)
            h5_ann = f.create_dataset("ann", (len(serialized),), dtype=dt)
            h5_ann[:] = serialized
            f.create_dataset("group_indice_range", data=json.dumps(group_indice_range))
        with open(Path(cache_dir) / "ready", "w") as f:
            f.write("ready")

    @staticmethod
    def _load_annotations_from_cache(cache_dir: str, process_index: int):
        import h5py

        while not (Path(cache_dir) / "ready").exists():
            assert process_index != 0, "rank 0 must have written the cache"
            time.sleep(1)
        cache_file = h5py.File(Path(cache_dir) / "data.h5", "r")
        annotations = cache_file["ann"]
        group_indice_range = json.loads(cache_file["group_indice_range"].asstr()[()])
        return annotations, group_indice_range

    # ------------------------- sampling -------------------------

    def _record(self, index: int) -> dict:
        item = self.ann[index]
        return json.loads(item) if self.cache_on_disk else copy.deepcopy(item)

    def _check_item_graph200k(self, index: int, image_type_list: list[str]) -> bool:
        return check_item_graph200k(self._record(index), image_type_list)

    def get_group_name(self, index: int) -> str | None:
        for group_name, idxs in self.group_indices.items():
            if idxs[0] <= index <= idxs[-1]:
                return group_name
        return None

    def get_context_index(self, index: int, tried: set[int], rng: random.Random) -> int:
        """Pick an untried in-group index; raises LookupError when the group
        is exhausted (the reference would spin forever — dataset.py:194-202)."""
        for _, idxs in self.group_indices.items():
            if idxs[0] <= index <= idxs[-1]:
                n = len(idxs)
                if len(tried) >= n:
                    raise LookupError("group exhausted for this task spec")
                if len(tried) * 2 < n:
                    # rejection sampling: O(1) amortized while the tried set
                    # is sparse (rebuilding the candidate list per draw was
                    # O(group) — quadratic over a mostly-failing group)
                    while True:
                        cand = idxs[rng.randrange(n)]
                        if cand not in tried:
                            break
                else:  # mostly exhausted: materialize the complement once
                    available = [i for i in idxs if i not in tried]
                    if not available:
                        raise LookupError("group exhausted for this task spec")
                    cand = rng.choice(available)
                index = cand
                tried.add(index)
                break
        return index

    def sample_group(self, rng: random.Random) -> str:
        groups = list(self.group_weights)
        weights = [self.group_weights[g] for g in groups]
        return rng.choices(groups, weights=weights, k=1)[0]

    def _item_rng(self, index: int) -> random.Random:
        """All per-item randomness is a pure function of (dataset seed, sampler
        index): identical runs replay identical grids, and resuming at step k
        reproduces the from-scratch sequence (ref anchors the record on the
        index, dataset.py:217-249; we anchor ALL the item's draws)."""
        return random.Random((self.seed << 48) ^ (index + 1))

    def __getitem__(self, index: int):
        rng = self._item_rng(index)
        group_name = self.sample_group(rng)
        check_item = self.check_item[group_name]
        tasks = self.task_dicts[group_name]
        task_weights = [t["sample_weight"] for t in tasks]
        group = self.group_indices[group_name]
        # the sampler-provided index anchors the first record (ref :217)
        anchor = group[index % len(group)]

        for attempt in range(10_000):
            # (re)sample task spec, context count, and starting index; bad
            # records or unsatisfiable specs fall through to a fresh draw
            # (ref dataset.py:217-249 retries within one spec and can spin;
            # resampling the spec is strictly more robust). The anchor is
            # kept on the first attempt; later attempts redraw from the rng.
            idx = anchor if attempt == 0 else rng.choice(group)
            tried: set[int] = {idx}
            context_num = rng.choices([1, 2, 3], weights=[0.3, 0.4, 0.3])[0]
            task_type = rng.choices(tasks, weights=task_weights)[0]
            image_type_list = rng.choice(task_type["image_list"])
            try:
                index_list: list[int] = []
                if check_item(idx, image_type_list):
                    index_list.append(idx)
                while len(index_list) < context_num:
                    idx = self.get_context_index(idx, tried, rng)
                    if check_item(idx, image_type_list):
                        index_list.append(idx)
                records = [self._record(i) for i in index_list]
                return self.item_processor.process_item(
                    records,
                    training_mode=True,
                    image_type_list=image_type_list,
                    context_num=context_num,
                    group_name=group_name,
                    rng=rng,
                )
            except LookupError:
                continue
            except Exception as e:
                logger.warning("record failed (%s); resampling", e)
        raise RuntimeError("could not assemble a valid grid sample")


def _prefix_paths(node, root: str):
    if isinstance(node, str):
        return os.path.join(root, node) if not os.path.isabs(node) else node
    if isinstance(node, dict):
        return {k: _prefix_paths(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_prefix_paths(v, root) for v in node]
    return node
