"""The LM scaffold's step functions — port of ``repro.train``, serving
half (``steps``: prefill and decode)."""
