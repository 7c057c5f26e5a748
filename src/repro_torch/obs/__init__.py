"""The span seam of ``repro.obs``, disabled.

Tracing is not ported yet (ROADMAP M10): ``ERConfig(trace=True)`` raises
``NotImplementedError`` in the facade, and every span here is a shared
no-op, so instrumented code keeps the reference's shape."""
from __future__ import annotations


class _NoopSpan:
    enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def span(name: str, /, **attrs) -> _NoopSpan:
    """A disabled span: a context manager that records nothing (``name``
    is positional-only, as in the reference, so ``name`` may also be an
    attribute)."""
    return NOOP_SPAN
