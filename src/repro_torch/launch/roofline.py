"""Roofline terms of the port's dry-run records (``launch.dryrun``), with
the H100's data-sheet peaks.  The port's counterpart of
``benchmarks/roofline.py``; it carries none of that script's TPU figures.

Per cell, with ``chips`` ranks each an NVIDIA H100 80GB HBM3 (SXM) at its
700 W limit (data-sheet peaks, dense; not measured):

  compute term    = FLOPs / (chips * peak)   peak 989e12 FLOP/s for bf16
                                             compute, 67e12 for f32
  memory term     = bytes / (chips * 3.35e12 B/s of HBM3)
  collective term = collective bytes per rank / 450e9 B/s (NVLink 4, each
                    way)

FLOPs and bytes are the cost model's global totals of the unsharded step
(``jaxpr_flops``, ``jaxpr_bytes``), the collective bytes the sharded step's
on one rank (``collective_bytes_per_rank``).  The bound on the cell's MFU
is JAX's: ``mfu_bound = (model_flops / (chips * peak)) / max(terms)``.

Usage (after the dry-run):
  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single|multi]
"""

from __future__ import annotations

import argparse
import json

from .dryrun import ART_DIR

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per card, each way (NVLink 4)


def load_cells(mesh: str = "single") -> list[dict]:
    cells = []
    for f in sorted(ART_DIR.glob(f"*__{mesh}.json")):
        d = json.loads(f.read_text())
        if d.get("status") in ("ok", "skipped"):
            cells.append(d)
    return cells


def roofline_terms(cell: dict, compute_dtype: str = "bfloat16") -> dict:
    chips = cell["chips"]
    peak = PEAK_FLOPS[compute_dtype]
    terms = {"compute": cell["jaxpr_flops"] / (chips * peak),
             "memory": cell["jaxpr_bytes"] / (chips * HBM_BW),
             "collective": cell.get("collective_bytes_per_rank", 0.0) / LINK_BW}
    dominant = max(terms, key=terms.get)
    ideal = cell["model_flops"] / (chips * peak)
    return {
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": dominant,
        "useful_ratio": cell["model_flops"] / max(cell["jaxpr_flops"], 1e-30),
        "mfu_bound": ideal / max(max(terms.values()), 1e-30),
    }


def _dtype(cell: dict) -> str:
    from repro_torch.configs import get_config

    cfg = get_config(cell["arch"]).replace(**cell.get("overrides", {}))
    return cfg.compute_dtype


def markdown_table(mesh: str = "single") -> str:
    lines = [f"Peaks: {CARD} data sheet (989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s HBM, "
             "450 GB/s NVLink each way); not measured.", "",
             "| arch | shape | compute (ms) | memory (ms) | collective (ms) | dominant | "
             "MODEL_FLOPS/FLOPs | MFU bound |",
             "|---|---|---|---|---|---|---|---|"]
    detailed = []
    for cell in load_cells(mesh):
        if cell["status"] == "skipped":
            lines.append(f"| {cell['arch']} | {cell['shape']} | — | — | — | "
                         "*skipped: full attention at 500k* | — | — |")
            continue
        r = roofline_terms(cell, _dtype(cell))
        detailed.append({**cell, **r, "peaks": CARD})
        lines.append(f"| {cell['arch']} | {cell['shape']} | {r['t_compute_s'] * 1e3:.2f} | "
                     f"{r['t_memory_s'] * 1e3:.2f} | {r['t_collective_s'] * 1e3:.2f} | "
                     f"**{r['dominant']}** | {r['useful_ratio']:.3f} | {r['mfu_bound']:.3f} |")
    (ART_DIR / f"roofline_{mesh}.json").write_text(json.dumps(detailed, indent=1, default=str))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    print(markdown_table(ap.parse_args(argv).mesh))


if __name__ == "__main__":
    main()
