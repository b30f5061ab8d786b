"""Training observability: a smoothed metric and per-step phase timers.

SmoothedValue and PhaseTimer copied from visualcloze_tpu/utils/misc.py, so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque


class SmoothedValue:
    """Track a series over a sliding window + global average
    (ref util/misc.py:20-74)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class PhaseTimer:
    """Per-step phase wall-clock (DataloadSecs/EncodeSecs/TrainSecs parity,
    ref train.py:591-664). Use .mark(name) between phases."""

    def __init__(self):
        self.meters: dict[str, SmoothedValue] = defaultdict(lambda: SmoothedValue(fmt="{avg:.3f}"))
        self._last = time.time()

    def mark(self, name: str) -> None:
        now = time.time()
        self.meters[name].update(now - self._last)
        self._last = now

    def reset(self) -> None:
        self._last = time.time()

    def summary(self) -> str:
        return " ".join(f"{k}: {v.avg:.3f}s" for k, v in self.meters.items())
