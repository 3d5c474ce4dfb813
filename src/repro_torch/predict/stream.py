"""Stream policies: the prediction strategies on the tensor store.

``runtime.prefetch.WeightStreamer`` is the weight-streaming analogue of the
POS session (DESIGN.md section 2); its ``mode`` string resolves through the
same registry as ``Session``'s.  A policy's single entry point mirrors the
injected scheduling point: it is called when the compute frontier enters a
group and decides which *future* groups to fetch.

  * ``capre``  — follows the statically derived PrefetchPlan ``k_ahead``
    groups ahead, collections included (zero runtime monitoring);
  * ``rop``    — schema-only: the next ``rop_depth`` groups in tree order,
    never collections (it cannot know a scan consumes all layers);
  * ``markov-miner`` — plan-blind: mines group-transition counts from a
    recorded group log (``WeightStreamer.group_log`` of a prior run) and
    follows the most likely successor chain;
  * ``hybrid`` — static plan for collection groups (stream them ahead like
    capre) + the mined transitions for everything else.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Sequence


class StreamPolicy:
    name = "?"

    def warm(self, group_trace: Sequence[int]) -> None:
        """Consume a recorded group-entry log from a prior run (miners)."""

    def on_group_start(self, streamer, group_index: int) -> None:
        raise NotImplementedError


class CapreStream(StreamPolicy):
    def on_group_start(self, streamer, group_index: int) -> None:
        groups = streamer._groups
        hi = min(group_index + 1 + streamer.k_ahead, len(groups))
        for gi in range(group_index + 1, hi):
            # one batched dispatch per plan group (deduped against cache +
            # in-flight in one snapshot) instead of one pool task per record
            streamer.fetch_group([rec.path for rec in groups[gi]])


class RopStream(StreamPolicy):
    def on_group_start(self, streamer, group_index: int) -> None:
        groups = streamer._groups
        hi = min(group_index + 1 + streamer.rop_depth, len(groups))
        for gi in range(group_index + 1, hi):
            # ROP cannot prefetch collections (section 2): skip stacked
            # layer groups entirely
            streamer.fetch_group(
                [rec.path for rec in groups[gi] if not rec.collection]
            )


class MarkovStream(StreamPolicy):
    """Order-1 transition mining over group indices.  Unwarmed it fetches
    nothing — the honest cold-start of a monitoring-based approach."""

    def __init__(self):
        self._table: dict[int, Counter] = {}
        self.train_seconds = 0.0

    def warm(self, group_trace: Sequence[int]) -> None:
        t0 = time.perf_counter()
        trace = list(group_trace)
        for a, b in zip(trace, trace[1:]):
            self._table.setdefault(a, Counter())[b] += 1
        self.train_seconds += time.perf_counter() - t0

    def on_group_start(self, streamer, group_index: int) -> None:
        groups = streamer._groups
        cur, fetched = group_index, 0
        while fetched < streamer.k_ahead:
            counts = self._table.get(cur)
            if not counts:
                break
            nxt = counts.most_common(1)[0][0]
            if not (0 <= nxt < len(groups)) or nxt == cur:
                break
            streamer.fetch_group([rec.path for rec in groups[nxt]])
            fetched += 1
            cur = nxt


class HybridStream(MarkovStream):
    def on_group_start(self, streamer, group_index: int) -> None:
        # static part: stream collection groups ahead (exact from the plan)
        groups = streamer._groups
        hi = min(group_index + 1 + streamer.k_ahead, len(groups))
        for gi in range(group_index + 1, hi):
            streamer.fetch_group(
                [rec.path for rec in groups[gi] if rec.collection]
            )
        # learned part: mined transitions cover the non-collection groups
        super().on_group_start(streamer, group_index)
