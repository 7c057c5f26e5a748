"""``repro_torch`` — Parallel Sorted Neighborhood blocking on PyTorch + CUDA.

The PyTorch port of ``repro`` (the JAX/Pallas reference package beside
it).  The module layout mirrors the reference so every module has a
counterpart of the same name:

  core/        entity schema, matchers, window band + band engines,
               partition functions, the SRP / RepSN / JobSN shard steps,
               the host sequential-SN oracles
  kernels/     hand-written Hopper kernels (``kernels/csrc``) behind
               PyTorch wrappers, each with its plain-PyTorch version
  api/         ``ERConfig``, variants, runners, ``resolve`` / ``link``
  balance/     key profile, shard planners, capacity sizing
  stream/      out-of-core streaming: chunk spool, external sort, the
               chunked resolve with its seam carry
  resilience/  the overflow-recovery ladder, checkpointed kill/resume,
               fault injection
  data/        corpus generators and the dedup stage
  quality/     adaptive windows, recall metrics against gold pairs
  serve/       online incremental serving: the sorted index, delta
               matching on the card, the micro-batched service and its
               admission control
  obs/         tracing + metrics: spans, counters, histograms, the
               ``TraceReport`` and its Chrome export
  perf/        the executable cache: CUDA graphs of the shard programs
  launch/      meshes (process groups) for the shard_map runner
  configs/     the LM scaffold's model and run configs (the ten archs)
  models/      the LM scaffold's models: attention (K4 on the card's
               sliding-window prefill), MoE, recurrent mixers, blocks,
               the LM, and the reference's trees carried across
  train/       the LM's serve steps (prefill, decode)

Differences of form, not of result: the shard axis the reference maps is
an explicit leading dim on every tensor of the shard program (r shards
under the vmap runner, one per rank under the shard_map runner), the
named-axis collectives become ops over that dim or ``torch.distributed``
calls (``core/collectives.py``), a cached executable is a CUDA graph, and
bit-packed signatures travel as int32 bit views of the reference's uint32
words.

Entry points (``api.resolve``, ``api.link``, ``api.resume``,
``api.serve``, ``stream.resolve_stream``, ``stream.link_stream``,
``api.VmapRunner``, ``api.ShardMapRunner``, ``models.lm.lm_init``,
``cache_init`` and ``forward``) run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
This package imports neither ``jax`` nor ``repro``.
"""
