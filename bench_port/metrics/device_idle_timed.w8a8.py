"""device_idle_timed.w8a8: readings.device_idle_timed, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import device_idle_timed as read  # noqa: F401
