"""The LM scaffold's models — port of ``repro.models``: modules,
attention (with K4 on the card's sliding-window prefill), MoE (single
device), the recurrent mixers, blocks, the LM, and ``convert`` (the
reference's parameter and cache trees as the port's)."""
