"""device_idle_timed: readings.device_idle_timed, in the cells whose queries time s_per_query."""

from bench_port.readings import device_idle_timed as read  # noqa: F401
