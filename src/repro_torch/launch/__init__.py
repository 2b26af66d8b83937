"""Launchers of the port, each runnable with ``python -m``: ``train`` (the
training loop over an ingested corpus), ``quickstart`` (ingest, train,
crash-restart, serve), ``train_lm``, ``serve`` (batched prefill + decode,
generations written through the ParallelWriter), ``serve_batch``,
``skim`` (the AGC skim, all five strategies), ``parallel_checkpoint``,
``recover`` (salvage a torn file), and the kernel timers
``attention_sweep`` and ``scan_builds``."""
