"""device_idle: readings.device_idle, in the cells whose queries time s_per_query."""

from bench_port.readings import device_idle as read  # noqa: F401
