"""preprocess_s: readings.preprocess_s, in the cells whose queries time s_per_query."""

from bench_port.readings import preprocess_s as read  # noqa: F401
