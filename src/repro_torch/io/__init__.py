"""On-disk persistence (paper §3.4, §4; SNIPPETS.md Snippet 1).

The storage layer proper, carried from ``repro.io``: it knows about
bytes, files and checksums, and nothing about the LSM-tree above it
(``repro_torch.db`` imports ``repro_torch.io``, never the other way
around). Every file it writes is byte-identical to the JAX package's, and
each package reads the other's files; ``docs/FORMAT.md`` is the spec.

Modules:

- ``io.sstable``    immutable table files: columnar key/value/seq/tomb
  sections, per-64KB-block CRC32C, optional Compressed Keys Block
  trailer; block-granular verified reads (``SSTableReader.read_block`` /
  ``section_rows``).
- ``io.ckb``        prefix-compressed sorted key streams with restart
  points; ``CKBReader`` gives random access (``key_at``) and bounded
  lower-bound ``seek`` without full decodes.
- ``io.blockcache`` the shared, bytes-budgeted LRU ``BlockCache`` over
  verified granules, shared across partitions (and stores).
- ``io.remix_io``   REMIX index (de)serialization into the port's torch
  ``Remix``; payload length is asserted equal to
  ``Remix.storage_bytes()`` (§3.4).
- ``io.rebuild``    incremental REMIX rebuild from the old selector
  stream + the tables' CKBs — zero value bytes read.
- ``io.manifest``   versioned registry with atomic rename commits +
  orphan GC (orphans are quarantined, then age-purged).
- ``io.faults``     the typed error taxonomy (``CorruptionError``,
  ``TransientIOError``, ``UnavailableSpanError``) + the deterministic
  ``FaultPlan`` injection shim and the ``IOContext`` retry policy
  threaded under every reader/writer in this package.
- ``io.checksum``   CRC32C.
"""
from repro_torch.io.blockcache import BlockCache  # noqa: F401
from repro_torch.io.checksum import crc32c  # noqa: F401
from repro_torch.io.ckb import CKBReader, decode_ckb, encode_ckb  # noqa: F401
from repro_torch.io.faults import (  # noqa: F401
    CorruptionError,
    FaultPlan,
    IOContext,
    TransientIOError,
    UnavailableSpanError,
    flip_bytes,
)
from repro_torch.io.manifest import Manifest, Storage  # noqa: F401
from repro_torch.io.rebuild import (  # noqa: F401
    decode_selector_order,
    incremental_build_remix,
)
from repro_torch.io.remix_io import dump_remix, load_remix  # noqa: F401
from repro_torch.io.sstable import SSTableReader, write_sstable  # noqa: F401
