"""Traffic kinds: one module a kind, each with ``run(...)``."""
