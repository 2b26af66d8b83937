"""The paper's own configuration: the RNT-J writer defaults.

The port's own copy of ``repro.configs.rntj_writer``.  It mirrors the
paper's evaluated setup (§6): 64 KiB uncompressed target page size,
cluster-granular buffered writing, zstd-class compression (zlib/DEFLATE
level 1 here — see DESIGN.md §3 hardware adaptation), and the
synthetic-benchmark event schema (id + Poisson(5) float vector).
"""

from repro_torch.core import Collection, Leaf, Schema, WriteOptions

SYNTH_EVENT_SCHEMA = Schema([
    Leaf("id", "int64"),
    Collection("vals", Leaf("_0", "float32")),
])

PAPER_WRITE_OPTIONS = WriteOptions(
    page_size=64 * 1024,          # paper §6.1 default
    codec="zlib",                 # stands in for zstd (DESIGN.md §3)
    level=1,
    cluster_bytes=8 * 1024 * 1024,
    buffered=True,                # unit of writing = cluster (paper §5)
)

UNBUFFERED_OPTIONS = WriteOptions(
    page_size=64 * 1024, codec="zlib", level=1,
    cluster_bytes=8 * 1024 * 1024, buffered=False,
)
