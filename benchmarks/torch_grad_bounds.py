"""The readings behind ``chip_smoke.py``'s bf16 gradient bound
(``GRAD_REL_TOL_BF16_F32``), on a CUDA card.

For each parameter seed, every training config of ``chip_smoke.py`` takes
its gradient check (``chip_smoke.check_grads``): chatglm3-6b at full width
and depth 2 (B=2, S=2048) and each smoke config that trains (B=2, S=128).
Each ``[grads]`` line gives the kernel path's worst leaf against the plain
chunked path's f32 gradient and the plain path's own bf16 gradient against
the same, in bf16 and in f32.  Exits non-zero where a check fails.

    python benchmarks/torch_grad_bounds.py --seeds 0 1 2
"""

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grad_bounds.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.phase_device(torch))
    cs.phase_build()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    counters = {"flash_attention_fwd": flash_attention_fwd,
                "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
                "flash_attention_bwd_dq": flash_attention_bwd_dq}
    smoke_counters = dict(counters, selective_scan_fwd=selective_scan_fwd,
                          rglru_gated_fwd=rglru_gated_fwd)
    for seed in args.seeds:
        cs.check_grads(torch, counters, get_config("chatglm3_6b").replace(n_layers=2), 2, 2048,
                       tag=f"grads seed {seed}", seed=seed)
        gc.collect()
        torch.cuda.empty_cache()
        for arch, head_dim, _, train in cs.SMOKE_CONFIGS:
            if train:
                cs.check_grads(torch, smoke_counters, cs.smoke_config(arch, head_dim), 2, 128,
                               tag=f"grads seed {seed}", seed=seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
