"""attention_roofline: readings.attention_roofline, in the cells whose queries time s_per_query."""

from bench_port.readings import attention_roofline as read  # noqa: F401
