"""attention_roofline.w8a8: readings.attention_roofline, in the w8a8 cell, whose queries time s_per_query.w8a8."""

from bench_port.readings import attention_roofline as read  # noqa: F401
