"""``repro_torch.stream`` — out-of-core streaming entity resolution (port
of ``repro.stream``).

The streaming twin of ``repro_torch.api``: consume an ITERATOR of entity
chunks, globally sort-partition them out-of-core (per-chunk device sorts +
k-way host merge, optionally spooled to disk), and drive the variant ×
runner × engine machinery chunk-by-chunk with a w−1 seam halo — the union
of emitted pairs is bit-identical to a monolithic ``api.resolve`` while
peak device residency stays bounded by ``chunk_size``.

    from repro_torch import api, stream
    from repro_torch.data import synth_entity_chunks

    res = stream.resolve_stream(
        synth_entity_chunks(seed=0, n=100_000, chunk=10_000),
        api.ERConfig(variant="repsn", hops=7, runner="vmap", num_shards=8),
        spool_dir="er-spool")             # host disk, not device memory
    res.pairs                  # == monolithic resolve on the full corpus
    res.stream.chunk_device_bytes  # peak device input bytes (vs corpus_bytes)

Runs on the CUDA card unless ``device="cpu"`` is passed.

Pieces:

  * resolver      ``resolve_stream`` / ``link_stream`` + ``StreamResult``
                  / ``StreamStats`` (the chunked drive loop, seam-halo
                  carry, SRP global-rank routing, multi-pass orchestration)
  * external_sort per-chunk device sorts + galloping k-way merge
  * store         ``ChunkStore``: the in-memory-or-disk chunk spool
"""
from repro_torch.stream.external_sort import merged_blocks, rechunk
from repro_torch.stream.resolver import (StreamResult, StreamStats,
                                         link_stream, resolve_stream)
from repro_torch.stream.store import ChunkStore

__all__ = [
    "resolve_stream", "link_stream",
    "StreamResult", "StreamStats",
    "ChunkStore", "merged_blocks", "rechunk",
]
