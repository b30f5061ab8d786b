"""dit_eval_ms.w8a8: readings.dit_eval_ms, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import dit_eval_ms as read  # noqa: F401
