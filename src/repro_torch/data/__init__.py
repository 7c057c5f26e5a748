"""Corpus generators (port of the parts of ``repro.data`` that the
planners and the quality harness use): ``zipf_entities``, the skewed
hot-key corpus, and ``labeled_corpus``, entities with known duplicate
clusters.  Both are bit-identical to the reference's by seed and return
port entity dicts on ``device`` ("cpu" unless asked)."""
from repro_torch.data.corpus import zipf_entities
from repro_torch.data.truth import TruthCorpus, labeled_corpus

__all__ = ["TruthCorpus", "labeled_corpus", "zipf_entities"]
