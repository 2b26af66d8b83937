"""Launchers of the port: ``serve`` (batched prefill + decode, generations
written through the ParallelWriter)."""
