"""The knee sweep of a chat cell: the cell's traffic offered at several
fixed rates, one after another in one process, each to a fresh batcher.

    python3 portbench/sweep.py --workload <chat cell> --seed <n> --seconds <s> --rates 4,6,8

For each rate it prints one JSON line: the rate offered, the requests sent
in the window and the share of them answered within it, ttft p50 and p90
(an unanswered request counts as infinite), tpot, and the backlog (requests
sent and not yet admitted) at the window's middle and at its end.  The
knee is the highest rate whose backlog does not grow; the cell's offered
rate is fixed at 0.7 of it (``cells/<name>.json``).  Nothing is drained
after the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run


def backlog(rec, t: float) -> int:
    return sum(1 for e in rec.requests if e["due"] <= t and not (e["times"] and e["times"][0] <= t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run.use_checkout_caches()
    import torch

    from pb import engine, spec, weights
    from pb.stats import gaps, percentile, window_requests
    from pb.traffic import Traffic
    from repro_torch.models.model import Model
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    cfg, mix = cell.config, cell.traffic
    dev = torch.device("cuda")
    run.load_kernels()
    tree = weights.make(cfg, args.seed, dev)
    model = Model(run.program_config(cfg), device=dev)
    for rate in (float(r) for r in args.rates.split(",")):
        batcher = ContinuousBatcher(model, tree, mix["slots"], mix["max_len"], device=dev)
        traffic = Traffic(mix, args.seed, cfg["vocab_size"], rate, args.seconds, cell.cell["warmup_s"])
        gen = engine.LoadGen(batcher, traffic, mix, Request)
        t = time.perf_counter()
        rec = gen.run(cfg, cell.cell["warmup_s"], args.seconds, drain_s=0.0)
        win = window_requests(rec)
        ttft = [(e["times"][0] - e["due"]) if e["times"] and e["times"][0] < rec.t_close
                else float("inf") for e in win]
        g = gaps(rec)
        print(json.dumps({
            "rate_rps": rate, "sent": len(win),
            "answered_share": sum(1 for x in ttft if x != float("inf")) / len(win),
            "ttft_p50_ms": percentile(ttft, 50) * 1e3, "ttft_p90_ms": percentile(ttft, 90) * 1e3,
            "tpot_ms": sum(g) / len(g) * 1e3,
            "backlog_mid": backlog(rec, (rec.t_open + rec.t_close) / 2),
            "backlog_end": backlog(rec, rec.t_close), "s": time.perf_counter() - t}), flush=True)
        gen.close()
        del batcher, gen
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
