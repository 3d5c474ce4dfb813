"""The one traffic generator: requests drawn from a mix's parameters and a
seed.

Lengths come from fixed tables of a clipped lognormal's quantiles (at the
midpoints (i + 0.5) / n), and an open loop's arrival gaps from a table of
the exponential's quantiles: Poisson arrivals, stratified.  Shuffles of the
tables, seeded with ``ORDER`` and not with the run's seed, set the order,
which the mix thus fixes: every seed offers the same requests in the same
order, and draws their tokens.  A 90th percentile of the time to first
token over some 100 requests moved by 10-13% between seeds when the seed
shuffled the order too (which arrivals meet another's admission), and by
half that between two runs of one seed; a closed loop's tokens per second
moved by 4% between seeds and by 1-2% between two runs of one.

- An open loop offers ``rate`` requests a second.  Its window is one pass
  through tables of n = rate x seconds entries, the gaps scaled to sum to
  the window: every window holds the same n arrivals at the same times
  with the same prompt and answer lengths.  The warm-up before the window
  takes its requests from another shuffle of the same tables, as many as
  fit into ``warmup_s``.
- A closed loop's requests go through tables of ``table`` entries, one
  shuffle after another.

Prompt tokens are uniform over the vocabulary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

# the streams of the shuffles and of the tokens
_PROMPT, _ANSWER, _GAP, _TOKENS = 1, 2, 3, 4
ORDER = 0  # seeds the shuffles


def lognormal_table(dist: dict, n: int) -> np.ndarray:
    """The ``n`` midpoint quantiles of a lognormal of ``median`` and
    ``sigma``, clipped to [min, max] and rounded to whole tokens."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    q = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.rint(q), dist["min"], dist["max"]).astype(np.int64)


def gap_table(n: int, total: float) -> np.ndarray:
    """The ``n`` midpoint quantiles of an exponential, scaled to sum to
    ``total`` seconds."""
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    return q * (total / q.sum())


@dataclass
class Request:
    index: int
    prompt: np.ndarray  # [S] int64
    answer: int  # tokens to serve, the first one included
    due: float  # seconds after the traffic starts (0 for a closed loop's)


class Traffic:
    """The requests of one mix and seed, by index in the order they are
    sent.  An open loop takes its ``rate`` (requests a second), the
    window's ``seconds`` and the warm-up's ``warmup_s``."""

    def __init__(self, mix: dict, seed: int, vocab: int, rate: float | None = None,
                 seconds: float | None = None, warmup_s: float = 0.0):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.plan = None
        if mix["loop"] == "open":
            self._plan_open(rate, seconds, warmup_s)
        else:
            n = mix["table"]
            self.tables = (lognormal_table(mix["prompt"], n), lognormal_table(mix["answer"], n))

    @staticmethod
    def _perm(stream: int, n: int, key: int = 0) -> np.ndarray:
        return np.random.default_rng([ORDER, stream, key]).permutation(n)

    def _plan_open(self, rate: float, seconds: float, warmup_s: float) -> None:
        """[(due, prompt length, answer length)]: the warm-up's requests, then
        the window's, due ``warmup_s`` + their offset into the window."""
        n = max(1, round(rate * seconds))
        prompts, answers = lognormal_table(self.mix["prompt"], n), lognormal_table(self.mix["answer"], n)
        gaps = gap_table(n, seconds)
        plan = []
        w_gaps, w_p, w_a = (self._perm(s, n, 1) for s in (_GAP, _PROMPT, _ANSWER))
        t = 0.0
        for i in range(n):  # back from the window's opening
            t += gaps[w_gaps[i]]
            if t > warmup_s:
                break
            plan.append((warmup_s - t, prompts[w_p[i]], answers[w_a[i]]))
        plan.reverse()
        p, a, g = (self._perm(s, n) for s in (_PROMPT, _ANSWER, _GAP))
        t = warmup_s
        for i in range(n):
            plan.append((t, prompts[p[i]], answers[a[i]]))
            t += gaps[g[i]]
        self.plan = plan

    def due(self, i: int) -> float:
        """When request ``i`` falls due: inf past an open loop's plan, and 0
        in a closed loop (its clients send when they are served)."""
        if self.plan is None:
            return 0.0
        return self.plan[i][0] if i < len(self.plan) else math.inf

    def request(self, i: int) -> Request:
        if self.plan is not None:
            due, S, answer = self.plan[i]
        else:
            n = self.mix["table"]
            due = 0.0
            S = self.tables[0][self._perm(_PROMPT, n, 2 + i // n)[i % n]]
            answer = self.tables[1][self._perm(_ANSWER, n, 2 + i // n)[i % n]]
        rng = np.random.default_rng([self.seed, _TOKENS, i])
        prompt = rng.integers(0, self.vocab, size=int(S), dtype=np.int64)
        return Request(i, prompt, int(answer), due)
