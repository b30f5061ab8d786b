"""dit_eval_ms: readings.dit_eval_ms, in the cells whose queries time s_per_query."""

from bench_port.readings import dit_eval_ms as read  # noqa: F401
