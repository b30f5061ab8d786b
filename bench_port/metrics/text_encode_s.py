"""text_encode_s: readings.text_encode_s, in the cells whose queries time s_per_query."""

from bench_port.readings import text_encode_s as read  # noqa: F401
