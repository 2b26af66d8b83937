"""Data pipeline of the port: parallel ingest -> single file -> packing
loader, the twin of ``repro.pipeline``."""

from .ingest import ingest_corpus, synth_corpus
from .loader import PackedLoader
from .tokens import DOC_SCHEMA, docs_to_batch

__all__ = ["DOC_SCHEMA", "docs_to_batch", "ingest_corpus", "synth_corpus",
           "PackedLoader"]
