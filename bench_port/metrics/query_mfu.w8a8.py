"""query_mfu.w8a8: readings.query_mfu, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import query_mfu as read  # noqa: F401
