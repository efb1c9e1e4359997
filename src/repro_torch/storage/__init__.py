"""repro_torch.storage — persistent index storage + streaming ingestion.

The ULISSE index as a durable, growable artifact, in the JAX package's
on-disk format (an index saved by either package opens in the other):

  * `format`  — manifest schema, atomic `*.tmp/` -> rename commit,
    format-version + EnvelopeParams compatibility validation;
  * `store`   — `save_index` / `open_index` (lazy mmap raw series) and
    the paged `PayloadStore`;
  * `writer`  — `Writer`: out-of-core bulk build via iSAX-sorted spill
    runs merged at finalize (the paper's one-pass bulk loader);
  * `delta`   — `extend_index` / `compact_index`: incremental ingestion
    into an unsorted delta set searched alongside the main index.

The engine-level surface is `UlisseEngine.open/save/from_writer/append/
compact` (core/engine.py).  The distributed saves (`save_distributed`,
`load_raw_data`) belong to the distributed backend, ROADMAP Queue 1
item 4.
"""
from repro_torch.storage.delta import compact_index, extend_index
from repro_torch.storage.format import (FORMAT_VERSION,
                                        IndexCompatibilityError,
                                        IndexFormatError)
from repro_torch.storage.store import (LazyCollection, PayloadStore,
                                       open_index, save_index)
from repro_torch.storage.writer import Writer

__all__ = [
    "FORMAT_VERSION", "IndexFormatError", "IndexCompatibilityError",
    "LazyCollection", "PayloadStore", "open_index", "save_index", "Writer",
    "extend_index", "compact_index",
]
