"""linears_roofline.w8a8: readings.linears_roofline, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import linears_roofline as read  # noqa: F401
