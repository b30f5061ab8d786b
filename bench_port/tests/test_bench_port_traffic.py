"""The traffic reproduces from its seed and keeps its source's proportions."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from bench_port.traffic import Traffic, load_mix


def _same(a: dict, b: dict) -> bool:
    return (a["prompts"] == b["prompts"] and a["seed"] == b["seed"] and a["shape"] == b["shape"]
            and all((x is None and y is None) or (x is not None and y is not None and
                                                  np.array_equal(np.asarray(x), np.asarray(y)))
                    for rx, ry in zip(a["grid"], b["grid"]) for x, y in zip(rx, ry)))


@pytest.mark.parametrize("mix", ["default_query", "graph200k_mix"])
def test_queries_reproduce_from_the_seed(mix):
    m = load_mix(mix)
    seed = 2 ** 33 + 17
    one, two, other = Traffic(m, seed), Traffic(m, seed), Traffic(m, seed + 1)
    for i in range(3):
        assert _same(one.query(i), two.query(i))
        assert not _same(one.query(i), other.query(i))
        assert one.query(i)["shape"] == other.query(i)["shape"]  # the seed draws no shapes
        assert one.query(i)["seed"] != 0
        assert one.query(i)["grid"][-1][-1] is None


def test_the_graph200k_cycle_keeps_the_source_proportions():
    from visualcloze_tpu_torch.data.prefix_instruction import style_list, test_task_dicts

    m = load_mix("graph200k_mix")
    cycle = [tuple(s) for s in m["cycle"]]
    n = len(cycle)
    rows = Counter(r for r, _ in cycle)
    assert [rows[r] for r in (1, 2, 3)] == [n // 3] * 3  # sample.py: context_num 1, 2, 3 alike
    # columns: what sample.py sends at each context_num, every distinct row spec of test_task_dicts,
    # a style slot counting two (the reader gives a style pair two cells)
    specs = {(t["task_name"], tuple(spec)) for t in test_task_dicts for spec in t["image_list"]}
    source = Counter(len(spec) + sum(s in style_list for s in spec) for _, spec in specs)
    assert set(source) == {2, 3, 4}
    cols = Counter(c for _, c in cycle)
    for c, k in source.items():
        assert abs(cols[c] - n * k / len(specs)) < 1.0
    for r in (1, 2, 3):  # rows and columns drawn apart, as sample.py's loops are nested
        assert Counter(c for rr, c in cycle if rr == r) == Counter({c: k // 3 for c, k in cols.items()})
    tokens = [r * c * 576 for r, c in cycle]
    assert min(tokens) == 1152 and max(tokens) == 6912


def test_the_default_query_is_the_demos():
    m = load_mix("default_query")
    assert m["cycle"] == [[2, 3]] and m["steps"] == 30 and m["upsampling"] and m["upsampling_steps"] == 10
    assert m["upsampling_noise"] == 0.4 and m["cfg"] == 30.0 and m["image_size"] == 1024
