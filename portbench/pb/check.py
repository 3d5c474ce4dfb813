"""The comparison that decides ``correct``: what the timed path served
against the plain reference (``reference.py``), after the window.

The readings (``_Max.readings``); the cell's file names those that its
limits hold:

- ``gap``: the widest gap, over the served tokens checked, by which a
  served token's reference logit lies below the reference's best logit at
  that position (0 where the reference would have served the same token);
- ``gap_mean``: the mean of those gaps over the served tokens checked.  A
  moe model's widest gap does not separate the program from the control
  by the 3x a limit needs (a bf16 rounding can send a token to the other
  of two near-equal experts, and the widest gap is such a token's); their
  mean does, as most tokens see no such flip;
- ``kv_rms``: the root mean square of the differences between the keys
  and values that the program wrote into its cache and the reference's,
  over the rows checked, as a share of the reference values' root mean
  square.

Which tokens and rows: the slots' rows do not meet, so each request is
checked whole.  A sample drawn from the seed of the requests that finished
(the longest among them) and of those still in a slot at the end: the
reference runs over each prompt with its served tokens and judges every
served token; for those still in a slot also every key and value its cache
row holds.

The control (``control.py``) computes the reference in fp8 at the same
positions and reads the same numbers of it: at each position the gap of the
token the control puts first, and its keys and values against the f32
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import Reference

_SAMPLE_STREAM = 5
TOKENS_PER_PASS = 8192  # prompt tokens the reference takes in one pass
LOGIT_ROWS = 1024  # positions whose logits are taken at once


@dataclass
class State:
    """What the program left after the window: the requests finished and
    those in a slot (with the slot), and the cache."""

    finished: list  # (prompt, served tokens)
    in_slots: list  # (slot, prompt, served tokens)
    cache_k: torch.Tensor  # [L, B, max_len, KV, hd]
    cache_v: torch.Tensor

    @classmethod
    def take(cls, batcher, requests: list) -> "State":
        finished = [(e["req"].prompt, list(e["req"].output)) for e in requests if e["req"].done]
        in_slots = [(i, s.req.prompt, list(s.req.output)) for i, s in enumerate(batcher.slots)
                    if s.busy]
        return cls(finished, in_slots, batcher.cache["k"], batcher.cache["v"])


class _Max:
    """Running widest and summed gap and RMS difference against the
    reference."""

    def __init__(self):
        self.gap = 0.0
        self.gap_sum = 0.0
        self.sq_diff = 0.0
        self.sq_ref = 0.0
        self.tokens = 0
        self.rows = 0

    def tokens_at(self, ref_logits, served):
        """``served`` [n] judged at the reference's logits [n, vocab]."""
        best = ref_logits.max(-1).values
        gap = best - ref_logits.gather(-1, served[:, None])[:, 0]
        self.gap = max(self.gap, float(gap.max()))
        self.gap_sum += float(gap.sum())
        self.tokens += len(served)

    def rows_at(self, got, want, n_rows: int):
        d = got.float() - want
        self.sq_diff += float((d * d).sum())
        self.sq_ref += float((want * want).sum())
        self.rows += n_rows

    def readings(self) -> dict:
        return {"gap": self.gap, "gap_mean": self.gap_sum / self.tokens if self.tokens else 0.0,
                "kv_rms": (self.sq_diff / self.sq_ref) ** 0.5 if self.sq_ref else 0.0,
                "tokens": self.tokens, "rows": self.rows}


def sample(state: State, seed: int, plan: dict) -> tuple[list, list]:
    """(finished requests, slots) to check, drawn from the seed: the longest
    finished request and ``plan["finished"] - 1`` others, and
    ``plan["in_slots"]`` of the slots held at the end."""
    rng = np.random.default_rng([seed, _SAMPLE_STREAM])
    fin = []
    if state.finished:
        order = sorted(range(len(state.finished)), key=lambda i: -len(state.finished[i][1]))
        rest = order[1:]
        pick = rng.choice(len(rest), size=min(len(rest), plan["finished"] - 1), replace=False)
        fin = [state.finished[order[0]]] + [state.finished[rest[i]] for i in sorted(pick)]
    n = min(len(state.in_slots), plan["in_slots"])
    slots = [state.in_slots[i] for i in sorted(rng.choice(len(state.in_slots), size=n, replace=False))]
    return fin, slots


def _passes(items: list):
    """Items [(tokens, ...)] grouped so that a pass takes about
    TOKENS_PER_PASS tokens."""
    group, n = [], 0
    for it in items:
        if group and n + len(it[0]) > TOKENS_PER_PASS:
            yield group
            group, n = [], 0
        group.append(it)
        n += len(it[0])
    if group:
        yield group


def compare(cfg: dict, tree: dict, state: State, seed: int, plan: dict, control: bool = False):
    """The readings of the program against the f32 reference and, with
    ``control``, of the fp8 control against it: (the program's readings,
    the control's or None)."""
    dev = state.cache_k.device
    fin, slots = sample(state, seed, plan)
    refs = {"f32": Reference(cfg, tree, "f32")}
    if control:
        refs["fp8"] = Reference(cfg, tree, "fp8")
    prog, ctrl = _Max(), _Max()

    def judge(want, got, served, rows):
        """want/got: one sequence's (final hidden, k, v) of the reference and
        of the control or None; served [n]; rows: the program's k and v to
        judge, or None.  The logits go in blocks of LOGIT_ROWS rows."""
        for a in range(0, len(served), LOGIT_ROWS):
            ref = refs["f32"].logits(want[0][a:a + LOGIT_ROWS])
            prog.tokens_at(ref, served[a:a + LOGIT_ROWS])
            if got is not None:
                ctrl.tokens_at(ref, refs["fp8"].logits(got[0][a:a + LOGIT_ROWS]).argmax(-1))
            del ref
        if rows is not None:
            prog.rows_at(rows[0], want[1], rows[0].shape[0] * rows[0].shape[1])
            prog.rows_at(rows[1], want[2], 0)
        if got is not None:
            ctrl.rows_at(got[1], want[1], 0)
            ctrl.rows_at(got[2], want[2], 0)

    # whole requests: (tokens, logits_from, served, rows)
    items = []
    for prompt, out in fin:
        items.append((np.concatenate([prompt, out[:-1]]), len(prompt) - 1, out, None))
    for slot, prompt, out in slots:
        seq = np.concatenate([prompt, out[:-1]])
        n = len(seq)
        items.append((seq, len(prompt) - 1, out,
                      (state.cache_k[:, slot, :n], state.cache_v[:, slot, :n])))
    for group in _passes(items):
        seqs = [torch.as_tensor(np.asarray(s, dtype=np.int64), device=dev) for s, *_ in group]
        froms = [f for _, f, _, _ in group]
        outs = {p: r.forward(seqs, froms) for p, r in refs.items()}
        for i, (_, _, served, rows) in enumerate(group):
            judge(outs["f32"][i], outs["fp8"][i] if control else None,
                  torch.as_tensor(served, device=dev), rows)
        del outs
    return prog.readings(), (ctrl.readings() if control else None)
