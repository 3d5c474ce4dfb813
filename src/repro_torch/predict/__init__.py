"""Prefetch prediction for the port's weight streamer: the stream policies
and the registry their ``mode`` strings resolve through (the stream side
of ``repro.predict``).

  ================  =============================
  name              tensor store (streamer)
  ================  =============================
  static-capre      plan-driven k-ahead
  (alias: capre)
  rop               next groups in tree order,
                    no collections
  markov-miner      group-transition mining
  (alias: markov)
  hybrid            plan collections + mined
                    transitions
  ================  =============================
"""

from .registry import available, canonical, get, make_stream_policy, register
from .stream import CapreStream, HybridStream, MarkovStream, RopStream, StreamPolicy

register(
    "static-capre",
    stream=CapreStream,
    aliases=("capre",),
    doc="code-analysis hints derived at registration time; zero monitoring",
)
register(
    "rop",
    stream=RopStream,
    doc="schema-based referenced-objects expansion (single associations only)",
)
register(
    "markov-miner",
    stream=MarkovStream,
    aliases=("markov",),
    doc="order-k frequent-sequence mining over recorded traces (monitoring)",
)
register(
    "hybrid",
    stream=HybridStream,
    doc="static hints for collections + trace-mined single-association chains",
)

__all__ = [
    "StreamPolicy",
    "CapreStream",
    "RopStream",
    "MarkovStream",
    "HybridStream",
    "register",
    "get",
    "canonical",
    "available",
    "make_stream_policy",
]
