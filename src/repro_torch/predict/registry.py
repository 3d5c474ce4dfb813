"""Predictor registry: ``mode`` strings resolve here (DESIGN.md section 3).

``Session(mode=...)`` and ``WeightStreamer(mode=...)`` used to branch on
hard-coded mode strings; both now resolve through this registry, so adding
a prediction strategy is one ``@register`` away from being runnable in the
POS interpreter, the weight streamer, the offline replay harness and the
benchmark driver.

Each entry couples up to two factories under one canonical name:

  * ``pos``    — a ``base.Predictor`` subclass for the object store
                 (``pos.client.Session``) and the offline replay harness;
  * ``stream`` — a ``stream.StreamPolicy`` subclass for the tensor-store
                 weight streamer (``runtime.prefetch.WeightStreamer``).

Aliases keep the historical spellings working: ``"capre"`` resolves to
``static-capre`` and ``"markov"`` to ``markov-miner``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class PredictorSpec:
    name: str
    pos: Optional[type] = None
    stream: Optional[type] = None
    doc: str = ""


_REGISTRY: dict[str, PredictorSpec] = {}
_ALIASES: dict[str, str] = {}


def register(name: str, *, pos: Optional[type] = None, stream: Optional[type] = None,
             aliases: tuple[str, ...] = (), doc: str = "") -> None:
    """Register a prediction strategy under ``name`` (idempotent per name:
    re-registration replaces, which keeps module reloads harmless)."""
    spec = PredictorSpec(name=name, pos=pos, stream=stream, doc=doc)
    _REGISTRY[name] = spec
    if pos is not None:
        pos.name = name
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
    ('pos' or 'stream')."""
    names = sorted(_REGISTRY)
    if kind is not None:
        names = [n for n in names if getattr(_REGISTRY[n], kind) is not None]
    return names


def make_pos_predictor(mode: str, **kwargs):
    spec = get(mode)
    if spec.pos is None:
        raise KeyError(f"mode {spec.name!r} has no object-store predictor")
    return spec.pos(**kwargs)


def make_stream_policy(mode: str, **kwargs):
    spec = get(mode)
    if spec.stream is None:
        raise KeyError(f"mode {spec.name!r} has no weight-stream policy")
    return spec.stream(**kwargs)
