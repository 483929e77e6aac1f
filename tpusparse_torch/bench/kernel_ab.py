"""Times the resident tile kernel (#5, ``tile_rows_cuda``) and the nested
stripe kernel (#11, ``stripe_nested_rows_cuda``) at the shapes where
``chip_smoke.py`` reads them, for the port in any checkout, so that two
commits are compared on one card in one run:

    python3 tpusparse_torch/bench/kernel_ab.py [--root DIR]

``--root`` is the checkout whose ``tpusparse_torch`` is timed (default: the
one holding this file), for example an older commit unpacked with ``git
archive`` into an ignored directory; run it in turns (older, newer, newer,
older).  The timer is this checkout's ``harness.device_time_fn``, loaded by
path, so an older checkout that lacks it is timed the same way.

Shapes: config #1 (power-law 32768^2, alpha 1.8, seed 42) in the tile
format of rb 1024, ct 1024, g 512 at K = 8, 32 and 256 and of rb 1024, ct
512, g 256 at K = 8; ``SparseLinear.from_dense(k_hint=512)``'s format of
the 90 %-pruned 4096^2 weight (seed 3) at K = 512; config #1's
``stripe_nested`` format (work 4096, unroll 8) at K = 8 and 32.  For each:
the device time a call (profiler, 20 calls: the wrapper's kernel and its
zero fill), the back-to-back time a call (``time_fn``, median of five, host
included) and the largest error against the plain version relative to
|A|·|X|.  Prints one JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose tpusparse_torch is timed")
    root = Path(ap.parse_args().root).resolve()
    spec = importlib.util.spec_from_file_location("kernel_ab_harness",
                                                  Path(__file__).with_name("harness.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from tpusparse_torch.format import pack_tile
    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels import stripe_gather as stripe
    from tpusparse_torch.kernels import tile_onehot as tile
    from tpusparse_torch.kernels.common import pad_dense_cols
    from tpusparse_torch.meta.set import create_init_metadata_set
    from tpusparse_torch.schedule import Schedule, build_plan, default_schedule

    dev = torch.device("cuda", 0)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip(), "shapes": {}}

    def record(name, kern, plain, scale, x):
        got, want, den = kern(x), plain(x), scale(x.abs())
        torch.cuda.synchronize()
        den = torch.maximum(den.double(), torch.ones((), dtype=torch.float64, device=dev))
        err = float(((got.double() - want.double()).abs() / den).max())
        host = float(np.median([harness.time_fn(kern, x) for _ in range(5)])) * 1e3
        device = harness.device_time_fn(kern, x) * 1e3
        out["shapes"][name] = {"device_ms": device, "time_fn_ms": host, "rel_err": err}
        print(f"{name}: device {device:.4f} ms a call, time_fn {host:.4f} ms, "
              f"rel err {err:.2e}", flush=True)

    def rand_x(n, k, kt):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((n, k)),
                            dtype=torch.float32, device=dev)
        return pad_dense_cols(x, -(-k // kt) * kt).contiguous()

    def tile_shape(name, fmt, k):
        kt = tile.choose_kt(min(tile.default_ktile(k), 32))
        kw = dict(rb=fmt.rb, ct=fmt.ct, kt=kt, mode="fp32x2")
        args = (fmt.chunk_tile, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        record(name, lambda v: tile.tile_rows_cuda(*args, v, **kw),
               lambda v: tile.tile_rows_plain(*args, v, **kw),
               lambda v: tile.tile_rows_plain(fmt.chunk_tile, fmt.cols, fmt.lrow,
                                              fmt.vals.abs(), fmt.nc_p, v, **kw),
               rand_x(fmt.shape[1], k, kt))

    def nested_shape(name, fmt, k):
        kt = stripe.choose_kt(k)
        rb = fmt.max_rows_per_stripe
        args = (fmt.cols, fmt.lrow, fmt.vals, fmt.wnz, fmt.wrow)
        record(name, lambda v: stripe.stripe_nested_rows_cuda(*args, v, rb=rb, kt=kt),
               lambda v: stripe.stripe_nested_rows_plain(*args, v, rb=rb),
               lambda v: stripe.stripe_nested_rows_plain(fmt.cols, fmt.lrow, fmt.vals.abs(),
                                                         fmt.wnz, fmt.wrow, v, rb=rb),
               rand_x(fmt.shape[1], k, kt))

    mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    ms = create_init_metadata_set(mat)
    f1024 = pack_tile(ms, 0, out_rows=32768, rb=1024, ct=1024, g=512, device=dev)
    for k in (8, 32, 256):
        tile_shape(f"#5 config #1 rb1024 ct1024 g512 K={k}", f1024, k)
    tile_shape("#5 config #1 rb1024 ct512 g256 K=8",
               pack_tile(ms, 0, out_rows=32768, rb=1024, ct=512, g=256, device=dev), 8)
    pw = builder.pruned_weight_coo(4096, 4096, 0.9, seed=3)
    tile_shape("#5 P13 from_dense(k_hint=512) K=512",
               build_plan(pw, default_schedule(pw, 512), device=dev).formats[0], 512)
    nested = build_plan(mat, Schedule(family="stripe_nested", work_per_block=4096, unroll=8),
                        device=dev).formats[0]
    for k in (8, 32):
        nested_shape(f"#11 config #1 stripe_nested K={k}", nested, k)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
