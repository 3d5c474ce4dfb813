"""Predictor registry of the port: ``WeightStreamer(mode=...)`` strings
resolve here.  The stream side of ``repro.predict.registry``: each entry
names one ``stream.StreamPolicy`` subclass under a canonical name, and
aliases keep the historical spellings working (``"capre"`` resolves to
``static-capre`` and ``"markov"`` to ``markov-miner``).  The object-store
predictors of the JAX package are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PredictorSpec:
    name: str
    stream: Optional[type] = None
    doc: str = ""


_REGISTRY: dict[str, PredictorSpec] = {}
_ALIASES: dict[str, str] = {}


def register(name: str, *, stream: Optional[type] = None,
             aliases: tuple[str, ...] = (), doc: str = "") -> None:
    """Register a prediction strategy under ``name`` (idempotent per name:
    re-registration replaces, which keeps module reloads harmless)."""
    _REGISTRY[name] = PredictorSpec(name=name, stream=stream, doc=doc)
    if stream is not None:
        stream.name = name
    for a in aliases:
        _ALIASES[a] = name


def canonical(mode: str) -> str:
    return _ALIASES.get(mode, mode)


def get(mode: str) -> PredictorSpec:
    key = canonical(mode)
    spec = _REGISTRY.get(key)
    if spec is None:
        raise KeyError(
            f"unknown prefetch mode {mode!r}; registered: {sorted(_REGISTRY)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return spec


def available(kind: Optional[str] = None) -> list[str]:
    """Canonical names, optionally filtered to those supporting ``kind``
    (only ``'stream'`` exists in the port)."""
    names = sorted(_REGISTRY)
    if kind is not None:
        names = [n for n in names if getattr(_REGISTRY[n], kind, None) is not None]
    return names


def make_stream_policy(mode: str, **kwargs):
    spec = get(mode)
    if spec.stream is None:
        raise KeyError(f"mode {spec.name!r} has no weight-stream policy")
    return spec.stream(**kwargs)
