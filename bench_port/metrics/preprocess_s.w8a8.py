"""preprocess_s.w8a8: readings.preprocess_s, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import preprocess_s as read  # noqa: F401
