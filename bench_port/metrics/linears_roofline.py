"""linears_roofline: readings.linears_roofline, in the cells whose queries time s_per_query."""

from bench_port.readings import linears_roofline as read  # noqa: F401
