"""repro_torch.io — streaming + out-of-core graph store.

Chunked binary edge shards (``edgefile``), bounded-memory canonicalization
and bit-identical streaming CSR builds (``stream``), a delta+varint packed
CSR container with lazy per-shard decompression (``compress``),
disk-spilled RMAT generation (``spill``), text edge-list ingest
(``ingest``) and the crash-safe directory publish (``atomicdir``).

Copies of the reference package's ``repro.io`` modules with the same
exports: every file either package writes is byte-identical to the
other's, and each reads the other's.  The package imports numpy only;
the few calls that stage arrays on a device (``graph_from_edgefile``,
``PackedCSR.to_graph``, ``PackedCSR.shard_device``) import torch when
called.
"""
from repro_torch.io.compress import (PackedCSR, PackedCSRWriter, pack_csr,
                                     varint_decode, varint_encode,
                                     zigzag_decode, zigzag_encode)
from repro_torch.io.csr import (CSRArrays, canonicalize_host,
                                csr_from_canonical, grid_assign_host)
from repro_torch.io.edgefile import (FLAG_CANONICAL, EdgeFile,
                                     EdgeFileWriter, write_edgefile)
from repro_torch.io.ingest import dump_text, ingest_text, iter_text_edges
from repro_torch.io.spill import spill_canonical_rmat, spill_rmat
from repro_torch.io.stream import (canonicalize_stream,
                                   csr_arrays_from_edgefile, csr_slot_stream,
                                   degree_indptr, graph_from_edgefile,
                                   infer_num_vertices, require_canonical,
                                   shard_edges_stream)

__all__ = [
    "CSRArrays", "EdgeFile", "EdgeFileWriter", "FLAG_CANONICAL",
    "PackedCSR", "PackedCSRWriter", "canonicalize_host",
    "canonicalize_stream", "csr_arrays_from_edgefile", "csr_from_canonical",
    "csr_slot_stream", "degree_indptr", "dump_text", "graph_from_edgefile",
    "grid_assign_host", "infer_num_vertices", "ingest_text",
    "iter_text_edges", "pack_csr",
    "require_canonical", "shard_edges_stream", "spill_canonical_rmat",
    "spill_rmat",
    "varint_decode", "varint_encode", "write_edgefile", "zigzag_decode",
    "zigzag_encode",
]
