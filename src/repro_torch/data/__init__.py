"""Corpus generators (port of ``repro.data``): the skewed
``zipf_entities``, the chunked stream sources ``synth_entity_chunks`` /
``zipf_entity_chunks``, the token corpus ``synth_corpus`` with
``doc_entities`` and the ``dedup_corpus`` stage, the LM train loop's
``TokenBatcher``, and ``labeled_corpus`` (entities with known duplicate
clusters).  All are bit-identical to the reference's by seed; entity
generators return port entity dicts on ``device`` ("cpu" unless asked)."""
from repro_torch.data.corpus import (DedupResult, TokenBatcher, dedup_corpus,
                                     doc_entities, synth_corpus,
                                     synth_entity_chunks, zipf_entities,
                                     zipf_entity_chunks)
from repro_torch.data.truth import TruthCorpus, labeled_corpus

__all__ = ["DedupResult", "TokenBatcher", "TruthCorpus", "dedup_corpus",
           "doc_entities", "labeled_corpus", "synth_corpus",
           "synth_entity_chunks", "zipf_entities", "zipf_entity_chunks"]
