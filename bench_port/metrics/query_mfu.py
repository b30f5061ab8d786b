"""query_mfu: readings.query_mfu, in the cells whose queries time s_per_query."""

from bench_port.readings import query_mfu as read  # noqa: F401
