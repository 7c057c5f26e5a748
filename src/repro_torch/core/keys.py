"""Blocking-key generation (port of ``repro.core.keys``): int32 torch on
the entities' device.

The paper uses "the lowercased first two letters of the title"; generally
the concatenated prefixes of a few attributes.  Keys are generated fully
vectorized from padded byte strings: each of the first ``k`` characters is
folded to a 6-bit code (lowercased a-z -> 1..26, digits -> 27..36, other
-> 0) and packed big-endian into an int32 (k <= 5 keeps keys < 2^30, so
the key space is totally ordered exactly like the string prefix order).
"""
from __future__ import annotations

import torch

KEY_MASK = (1 << 30) - 1    # entities.py schema: keys non-negative, < 2^30


def char_code(c: torch.Tensor) -> torch.Tensor:
    """uint8 char -> 6-bit code, case-folded (int32)."""
    c = c.to(torch.int32)
    lower = torch.where((c >= 65) & (c <= 90), c + 32, c)   # fold A-Z
    az = (lower >= 97) & (lower <= 122)
    dg = (lower >= 48) & (lower <= 57)
    zero = torch.zeros_like(lower)
    return torch.where(az, lower - 96,
                       torch.where(dg, lower - 48 + 27, zero))


def prefix_key(text: torch.Tensor, k: int = 2) -> torch.Tensor:
    """text: (N, L) uint8 padded strings -> (N,) int32 blocking keys."""
    if k > 5:
        raise ValueError("k>5 overflows int32 key space")
    codes = char_code(text[:, :k])                          # (N, k)
    weights = 64 ** torch.arange(k - 1, -1, -1, dtype=torch.int32,
                                 device=text.device)
    return (codes * weights[None, :]).sum(dim=1).to(torch.int32)


def multipass_keys(text: torch.Tensor, passes: int = 2, k: int = 2):
    """Multi-pass SN (paper §4): different key functions per pass.  Pass p
    uses the prefix starting at offset p (a standard multi-pass choice)."""
    return [prefix_key(text[:, p:], k=k) for p in range(passes)]


def key_range(k: int = 2) -> int:
    """Size of the key space a ``k``-character ``prefix_key`` can produce."""
    return 64 ** k


def derive_sort_key(ents: dict, spec) -> torch.Tensor:
    """Derive the sort key one multi-pass blocking pass uses.

    ``spec`` is an ``api.config.SortKeySpec``.  Returns an (N,) int32
    tensor in the entity key space (non-negative, < 2^30) on the entities'
    device.  Raises ``KeyError`` when the named payload field is absent and
    ``ValueError`` when the field's shape does not match the kind (prefix
    needs (N, L) bytes, word needs a 2-D integer tensor).  Signature words
    are int32 bit views here, so masking keeps the reference's low 30 bits.
    """
    if spec.kind == "identity":
        src = ents["key"] if spec.source == "key" \
            else ents["payload"][spec.source]
        if src.dim() != 1:
            raise ValueError(f"identity sort key needs a 1-D field, got "
                             f"{spec.source!r} with shape {tuple(src.shape)}")
        return src.to(torch.int32) & KEY_MASK
    field = ents["payload"][spec.source]
    if spec.kind == "prefix":
        if field.dim() != 2 or field.shape[1] < spec.offset + spec.width:
            raise ValueError(f"prefix sort key needs an (N, L) byte field "
                             f"with L >= offset+width="
                             f"{spec.offset + spec.width}, got "
                             f"{spec.source!r} with shape "
                             f"{tuple(field.shape)}")
        return prefix_key(field[:, spec.offset:], k=spec.width)
    # spec.kind == "word" (validated at SortKeySpec construction)
    if field.dim() != 2 or spec.index >= field.shape[1]:
        raise ValueError(f"word sort key needs column {spec.index} of a 2-D "
                         f"field, got {spec.source!r} with shape "
                         f"{tuple(field.shape)}")
    return field[:, spec.index].to(torch.int32) & KEY_MASK
