"""resident_gib: readings.resident_gib, in every cell."""

from bench_port.readings import resident_gib as read  # noqa: F401
