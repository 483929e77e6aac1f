"""Times the transpose apply's column walk (#15, ``dx_walk_kernel``) with a
part of its work taken out, to see which part sets its pace: copies of
``csrc/sddmm.cu`` patched so, built with the package's nvcc flags into
``tpusparse_torch/_build/`` and loaded beside the package's own library:

  as built      the source unchanged;
  staging only  the walking warps wait for each stage and release it
                without walking it (the sparse slots are still walked);
  walk only     the staging warp copies the first kDxStages pieces only and
                then releases each later stage at once, so the warps walk
                stale stages (wrong sums: a diagnostic, never a result).

    python3 tpusparse_torch/bench/dx_parts.py

At the shapes where ``chip_smoke.py`` reads #15: the trainable layer's span
format of the 90 %-pruned 4096^2 weight (seed 3) at K = 512 in fp32x2 and
bf16, and config #1's span format (power-law 32768^2, alpha 1.8, seed 42;
rb 512, ct 512, g 128) at K = 8.  For each: the device time a call of each
part (``harness.device_time_fn``, the profiler over 20 calls: the
preparation kernel and the walk) and, as built, the largest error against
``dx_rows_plain`` relative to |A|^T·|dY|.  Prints one JSON object as its
last line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tpusparse_torch.bench import harness  # noqa: E402
from tpusparse_torch.io import builder  # noqa: E402
from tpusparse_torch.kernels import build  # noqa: E402
from tpusparse_torch.kernels import sddmm as sd  # noqa: E402
from tpusparse_torch.kernels import span_gather as span  # noqa: E402

WALK = "      walk_staged<TPS, BF16>(acc[c], se, sd, so[p0 + c], so[p0 + c + 1], sub);"
WAIT_EMPTY = "      if (s >= kDxStages) gather::mbar_wait(empty + b, (s / kDxStages - 1) & 1);"
# the staging warp, after its wait: copy nothing past the first stages
SKIP = ("      if (s >= kDxStages) {\n"
        "        if (lane == 0) gather::mbar_arrive(full + b);\n"
        "        pc = next;\n"
        "        continue;\n"
        "      }")
PARTS = {"as built": [], "staging only": [(WALK, "      (void)se; (void)sd; (void)so;")],
         "walk only": [(WAIT_EMPTY, WAIT_EMPTY + "\n" + SKIP)]}


def part_library(name: str, patches) -> ctypes.CDLL:
    """csrc/sddmm.cu with ``patches`` applied (each must apply once), built
    beside the package's libraries and loaded, with dx_walk_launch's C
    signature."""
    src = (build.CSRC / "sddmm.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"dx_parts: the patch for {name!r} does not apply to sddmm.cu")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu = build.BUILD_DIR / f"dx_part_{tag}.cu"
    so = build.BUILD_DIR / f"libdx_part_{tag}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.dx_walk_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.dx_walk_launch.restype = ctypes.c_int
    return lib


def device_ms(fn, x) -> tuple[float, str]:
    """Device ms a call, and how it was read."""
    for _ in range(3):
        try:
            return harness.device_time_fn(fn, x) * 1e3, "profiler"
        except RuntimeError:
            pass
    return harness.graph_time_fn(fn, x) * 1e3, "graph replay"


def main() -> int:
    if not torch.cuda.is_available():
        print("dx_parts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(power, flush=True)
    libs = {name: part_library(name, patches) for name, patches in PARTS.items()}
    cases = (("T1 pruned 4096^2 (8, 1639, 128)", builder.pruned_weight_coo(4096, 4096, 0.9, seed=3),
              512, ("fp32x2", "bf16")),
             ("config #1 span rb512 ct512 g128", builder.power_law_coo(
                 32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42), 8, ("fp32x2",)))
    out = {"power": power, "points": []}
    for label, a, k, modes in cases:
        fmt = span.pack_span(a, rb=512, ct=512, g=128, keep_perm=True, device=dev)
        index = sd.dx_index(fmt)
        vals = fmt.vals.float().contiguous()
        rows, n = fmt.n_programs * fmt.rb, a.shape[1]
        kt = sd._k_tile(k, None)
        dy = torch.as_tensor(np.random.default_rng(k).standard_normal((rows, k)),
                             dtype=torch.float32, device=dev)
        for mode in modes:
            bf16 = mode == "bf16"
            for name, lib in libs.items():
                def call(d, lib=lib, bf16=bf16):
                    dx = torch.empty((n, k), device=dev)
                    ent = torch.empty((index.n_slots + 1, 2), dtype=torch.int32, device=dev)
                    dyr = torch.empty_like(d) if bf16 else dx
                    ts = (index.row, index.slot, vals, index.pieces, index.piece_off,
                          index.tile_pieces, index.uoff, index.colpos, d, dx, ent, dyr)
                    rc = lib.dx_walk_launch(*(t.data_ptr() for t in ts), index.n_slots,
                                            index.n_tiles, rows, n, k, int(bf16),
                                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"dx_walk_launch ({name}) failed with CUDA error {rc}")
                    return dx

                err = None
                if name == "as built":
                    kw = dict(n=n, rb=fmt.rb, kt=kt)
                    want = sd.dx_rows_plain(fmt.c0, fmt.cols, fmt.lrow, vals, fmt.nc_p, dy,
                                            **kw, mode=mode)
                    scale = sd.dx_rows_plain(fmt.c0, fmt.cols, fmt.lrow, vals.abs(), fmt.nc_p,
                                             dy.abs(), **kw, mode="fp32")
                    err = float(((call(dy) - want).abs() / scale.clamp(min=1e-30)).max())
                ms, how = device_ms(call, dy)
                print(f"{label} K={k} {mode} {name}: {ms:.4f} ms ({how})"
                      + ("" if err is None else f", rel err {err:.2e}"), flush=True)
                out["points"].append(dict(shape=label, k=k, mode=mode, part=name, device_ms=ms,
                                          read_by=how, rel_err=err))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
