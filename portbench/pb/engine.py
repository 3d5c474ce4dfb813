"""The load generator and its records: one host loop that submits the
traffic's requests to the program's ``ContinuousBatcher`` and steps it.

An open loop submits each request when it falls due, whatever the engine
is doing, and sleeps when nothing is due and nothing runs; a closed loop
keeps ``clients`` requests in the system, each client sending its next
request as soon as its last one is served.  Traffic starts ``warmup_s``
before the window opens, so that the window sees the engine in steady
state.  Once the window closes nothing more is sent, and the engine is
stepped until every request sent in the window has its first token, for up
to ``DRAIN_S``.

Times are the host's ``perf_counter``: an admission ends in the read of its
first token and a tick in the read of its next tokens, both of which wait
for the device.  The batcher's ``_admit_one`` and ``_decode`` are wrapped
on the instance to take those times (and, in a traced run, the spans and
the launch counters around each admission).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .trace import span

DRAIN_S = 60.0


@dataclass
class Record:
    """What a run leaves for the metric readers (times in host seconds)."""

    cfg: dict
    t_open: float
    t_close: float
    requests: list = field(default_factory=list)  # dicts: due, each token's time, req
    admissions: list = field(default_factory=list)  # (t0, t1, S, flash launches or None)
    steps: list = field(default_factory=list)  # (t0, t1, admissions in it)
    ticks: list = field(default_factory=list)  # traced runs: (kv lens of every row, busy rows)
    setup_s: float | None = None
    peak_bytes: int | None = None
    trace: dict | None = None  # trace.reduce's, for a traced run


class LoadGen:
    def __init__(self, batcher, traffic, mix: dict, request_cls, tracer=None, flash_launches=None):
        self.b, self.traffic, self.mix = batcher, traffic, mix
        self.request_cls = request_cls
        self.tracer = tracer
        self.flash_launches = flash_launches  # () -> the flash forward's launches so far
        self.rec = None
        self._live: dict = {}
        self._next = 0
        admit, decode = batcher._admit_one, batcher._decode

        def admit_one(i, slot, req):
            n = len(self.rec.admissions)
            f0 = self.flash_launches() if self.flash_launches else None
            t0 = time.perf_counter()
            self._traced(f"pb.admit.{n}", admit, i, slot, req)
            t1 = time.perf_counter()
            self._live[req.rid]["times"].append(t1)
            flash = self.flash_launches() - f0 if self.flash_launches else None
            self.rec.admissions.append((t0, t1, len(req.prompt), flash))

        def decode_(tokens, lens):
            busy = [s.busy for s in batcher.slots]
            nxt = self._traced(f"pb.tick.{len(self.rec.ticks)}", decode, tokens, lens)
            if tracer is not None:
                self.rec.ticks.append(((lens + 1).tolist(), busy))
            return nxt

        batcher._admit_one = admit_one
        batcher._decode = decode_

    def _traced(self, name: str, fn, *args):
        """``fn(*args)``, inside the span ``name`` in a traced run."""
        if self.tracer is None:
            return fn(*args)
        with span(name):
            return fn(*args)

    def close(self) -> None:
        """Give the batcher back its own methods."""
        del self.b._admit_one, self.b._decode

    def _send(self, due: float) -> None:
        r = self.traffic.request(self._next)
        self._next += 1
        req = self.request_cls(rid=r.index, prompt=r.prompt, max_new_tokens=r.answer)
        entry = {"due": due, "times": [], "req": req}
        self.rec.requests.append(entry)
        self._live[req.rid] = entry
        self.b.submit(req)

    def _step(self) -> int:
        """One engine step, timed; returns how many requests it finished."""
        n_admit = len(self.rec.admissions)
        t0 = time.perf_counter()
        self._traced("pb.step", self.b.step)
        t = time.perf_counter()
        self.rec.steps.append((t0, t, len(self.rec.admissions) - n_admit))
        finished = 0
        for rid, e in list(self._live.items()):
            out = e["req"].output
            while len(e["times"]) < len(out):
                e["times"].append(t)
            if e["req"].done:
                del self._live[rid]
                finished += 1
        return finished

    def _sleep_until(self, t: float) -> None:
        wait = t - time.perf_counter()
        if wait > 0:
            self._traced("pb.wait", time.sleep, wait)

    def run(self, cfg: dict, warmup_s: float, seconds: float, trace_s: float = 0.0,
            drain_s: float = DRAIN_S) -> Record:
        """Serve the traffic: ``warmup_s`` before the window, ``seconds`` in
        it, then the drain, for up to ``drain_s``.  A traced run profiles
        the window's first ``trace_s`` seconds."""
        open_loop = self.mix["loop"] == "open"
        t_start = time.perf_counter()
        rec = self.rec = Record(cfg=cfg, t_open=t_start + warmup_s,
                                t_close=t_start + warmup_s + seconds)
        if not open_loop:
            for _ in range(self.mix["clients"]):
                self._send(t_start)
        opened = traced = False
        while True:
            now = time.perf_counter()
            if not opened and now >= rec.t_open:
                opened = True
                if self.tracer is not None:
                    self.tracer.start()
                    traced = True
            if traced and now >= rec.t_open + trace_s:
                self.tracer.stop()
                traced = False
            if now >= rec.t_close:
                pending = [e for e in rec.requests
                           if rec.t_open <= e["due"] < rec.t_close and not e["times"]]
                if not pending or now >= rec.t_close + drain_s:
                    break
            elif open_loop:
                while t_start + self.traffic.due(self._next) <= now:
                    self._send(t_start + self.traffic.due(self._next))
            if self.b.queue or any(s.busy for s in self.b.slots):
                finished = self._step()
                if not open_loop and now < rec.t_close:
                    t = time.perf_counter()
                    for _ in range(finished):  # each client sends its next request
                        self._send(t)
            elif open_loop and now < rec.t_close:
                self._sleep_until(min(t_start + self.traffic.due(self._next), rec.t_close))
            else:
                break
        if traced:
            self.tracer.stop()
        return rec
