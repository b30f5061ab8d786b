"""vae_s: readings.vae_s, in the cells whose queries time s_per_query."""

from bench_port.readings import vae_s as read  # noqa: F401
