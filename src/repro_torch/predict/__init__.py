"""Pluggable prefetch-prediction subsystem (DESIGN.md section 3).

One registry hosts every prediction strategy the paper compares (and the
ones it only argues against):

  ================  =============================  =========================
  name              object store (Session)          tensor store (streamer)
  ================  =============================  =========================
  static-capre      hints + injected closures       plan-driven k-ahead
  (alias: capre)    (zero monitoring)
  rop               miss-driven BFS over single     next groups in tree
                    associations                    order, no collections
  markov-miner      order-k trace mining            group-transition mining
  (alias: markov)   (Palpatine-style)
  hybrid            static collections + mined      plan collections + mined
                    single chains (GrASP-style)     transitions
  ================  =============================  =========================

``pos.client.Session(mode=...)`` and ``runtime.prefetch.WeightStreamer
(mode=...)`` both resolve their mode strings here; ``predict.evaluate``
replays recorded traces against every registered predictor offline.
"""

from .base import Overhead, Predictor
from .hybrid import Hybrid
from .markov import MarkovMiner
from .registry import (
    available,
    canonical,
    get,
    make_pos_predictor,
    make_stream_policy,
    register,
)
from .rop import Rop
from .static_capre import StaticCapre
from .stream import CapreStream, HybridStream, MarkovStream, RopStream, StreamPolicy

register(
    "static-capre",
    pos=StaticCapre,
    stream=CapreStream,
    aliases=("capre",),
    doc="code-analysis hints derived at registration time; zero monitoring",
)
register(
    "rop",
    pos=Rop,
    stream=RopStream,
    doc="schema-based referenced-objects expansion (single associations only)",
)
register(
    "markov-miner",
    pos=MarkovMiner,
    stream=MarkovStream,
    aliases=("markov",),
    doc="order-k frequent-sequence mining over recorded traces (monitoring)",
)
register(
    "hybrid",
    pos=Hybrid,
    stream=HybridStream,
    doc="static hints for collections + trace-mined single-association chains",
)

__all__ = [
    "Overhead",
    "Predictor",
    "StaticCapre",
    "Rop",
    "MarkovMiner",
    "Hybrid",
    "StreamPolicy",
    "CapreStream",
    "RopStream",
    "MarkovStream",
    "HybridStream",
    "register",
    "get",
    "canonical",
    "available",
    "make_pos_predictor",
    "make_stream_policy",
]
