"""Sweeps the transpose apply's column walk (#15, ``dx_rows_cuda``) over K
at the shapes where ``chip_smoke.py`` reads #15: the trainable layer's
span format of the 90 %-pruned 4096^2 weight (seed 3; (P, NC, G) = (8,
1639, 128), every window staged) and config #1's span format (power-law
32768^2, alpha 1.8, seed 42; rb 512, ct 512, g 128: a sixth of the slots
in windows that hold at least one slot a row).  A block walks one tile of
128 columns of A for one panel of up to 128 columns of K, so the grid
grows with K up to 128 and the work a block does after it:

    python3 tpusparse_torch/bench/dx_k_sweep.py [--ks 8,32,512]

For each shape, K (padded to the K-tile span_dx pads it to) and mode
(fp32x2; bf16 at K = 512): the grid, the device time a call
(``harness.device_time_fn``, the profiler over 20 calls: the preparation
kernel and the walk; a CUDA graph's replay where the profiler drops
records in every window, said in the output) and the largest error against
``dx_rows_plain`` relative to |A|^T·|dY|.  Prints one JSON object as its
last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tpusparse_torch.bench import harness  # noqa: E402
from tpusparse_torch.io import builder  # noqa: E402
from tpusparse_torch.kernels import sddmm as sd  # noqa: E402
from tpusparse_torch.kernels import span_gather as span  # noqa: E402

KS = (8, 16, 32, 64, 128, 256, 512)


def device_ms(fn, x) -> tuple[float, str]:
    """Device ms a call, and how it was read."""
    for _ in range(3):
        try:
            return harness.device_time_fn(fn, x) * 1e3, "profiler"
        except RuntimeError:
            pass
    return harness.graph_time_fn(fn, x) * 1e3, "graph replay"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default=",".join(map(str, KS)), help="comma-separated K values")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dx_k_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(power, flush=True)
    shapes = {
        "T1 pruned 4096^2 (8, 1639, 128)": builder.pruned_weight_coo(4096, 4096, 0.9, seed=3),
        "config #1 span rb512 ct512 g128": builder.power_law_coo(
            32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)}
    out = {"power": power, "points": []}
    for label, a in shapes.items():
        fmt = span.pack_span(a, rb=512, ct=512, g=128, keep_perm=True, device=dev)
        index = sd.dx_index(fmt)
        vals = fmt.vals.float().contiguous()
        planes = (fmt.c0, fmt.cols, fmt.lrow, vals, fmt.nc_p)
        rows = fmt.n_programs * fmt.rb
        print(f"{label}: {index.n_slots} slots, {index.n_staged} in {index.n_pieces} pieces, "
              f"index {index.nbytes / 2**20:.2f} MiB", flush=True)
        for k in map(int, args.ks.split(",")):
            kt = sd._k_tile(k, None)
            kp = -(-k // kt) * kt
            dy = torch.zeros((rows, kp), device=dev)
            dy[:, :k] = torch.as_tensor(np.random.default_rng(k).standard_normal((rows, k)),
                                        dtype=torch.float32, device=dev)
            for mode in ("fp32x2", "bf16") if k == 512 else ("fp32x2",):
                kw = dict(n=a.shape[1], rb=fmt.rb, kt=kt, mode=mode, index=index)
                plain_kw = dict(n=a.shape[1], rb=fmt.rb, kt=kt)
                want = sd.dx_rows_plain(*planes, dy, **plain_kw, mode=mode)
                scale = sd.dx_rows_plain(fmt.c0, fmt.cols, fmt.lrow, vals.abs(), fmt.nc_p,
                                         dy.abs(), **plain_kw, mode="fp32")

                def fn(d, kw=kw):
                    return sd.dx_rows_cuda(*planes, d, **kw)

                err = float(((fn(dy) - want).abs() / scale.clamp(min=1e-30)).max())
                ms, how = device_ms(fn, dy)
                q4 = kp // 4
                panels = -(-q4 // min(32, 1 << (q4.bit_length() - 1)))
                print(f"  K={k} (Kp {kp}) {mode}: grid {index.n_tiles} x {panels}, {ms:.4f} ms "
                      f"({how}), rel err {err:.2e}", flush=True)
                out["points"].append(dict(shape=label, k=k, kp=kp, mode=mode,
                                          blocks=index.n_tiles * panels, device_ms=ms,
                                          read_by=how, rel_err=err))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
