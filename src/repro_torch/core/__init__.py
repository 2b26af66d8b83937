"""repro_torch.core — parallel writing of nested data in columnar formats.

The port's twin of ``repro.core`` (Hahnfeld, Blomer, Kollegger 2024):
nested schemas decomposed into offset+leaf columns, pages as units of
compression, relocatable clusters as units of writing, a multithreaded
single-file writer whose only synchronization is a short reserve+metadata
critical section, and the reader with its device read-back.  Files are
byte-identical to ``repro.core``'s for one producer.

Writers and the reader take ``device=`` (default ``"cuda"``): the
offsets scan, the seal's byte-plane split and the device decode chain
run as CUDA kernels there, or as their plain PyTorch versions on
``device="cpu"``.
"""

from .schema import (
    Schema,
    Field,
    Leaf,
    Collection,
    Record,
    ColumnSpec,
    ColumnBatch,
    KIND_LEAF,
    KIND_OFFSET,
    decompose_entry,
    recompose_entries,
)
from .writer import (
    WriteOptions,
    SequentialWriter,
    ParallelWriter,
    FillContext,
    write_entries,
    write_options_from_dict,
)
from .reader import ReadOptions, RNTJReader, slice_entry_range
from .filter import (
    F,
    Expr,
    Zone,
    T_FALSE,
    T_MAYBE,
    T_TRUE,
    required_columns,
)
from .container import (
    Sink,
    FileSink,
    AsyncFileSink,
    DevNullSink,
    LatencyModel,
    MemorySink,
    ThrottledSink,
    close_all,
    open_sink,
)
from .stats import ReaderStats, WriterStats, CountingLock
from .colbuf import ColumnBuffer
from .bufpool import BufferPool, PoolStats, Recyclable
from .ioengine import IOEngine, Retrier, RetryPolicy
from . import (
    bufpool, cluster, colbuf, compression, encoding, ioengine, metadata,
    pages,
)

__all__ = [
    "Schema", "Field", "Leaf", "Collection", "Record", "ColumnSpec",
    "ColumnBatch", "KIND_LEAF", "KIND_OFFSET", "decompose_entry",
    "recompose_entries", "WriteOptions", "SequentialWriter", "ParallelWriter",
    "FillContext", "write_entries", "write_options_from_dict",
    "RNTJReader", "ReadOptions", "slice_entry_range",
    "F", "Expr", "Zone", "T_FALSE", "T_MAYBE", "T_TRUE", "required_columns",
    "Sink", "FileSink", "AsyncFileSink",
    "DevNullSink", "LatencyModel", "MemorySink", "ThrottledSink",
    "close_all", "open_sink",
    "WriterStats", "ReaderStats", "CountingLock", "ColumnBuffer",
    "BufferPool", "PoolStats", "Recyclable", "IOEngine", "Retrier",
    "RetryPolicy",
    "bufpool", "cluster", "colbuf", "compression", "encoding", "ioengine",
    "metadata", "pages",
]
