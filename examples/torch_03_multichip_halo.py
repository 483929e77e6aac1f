"""Multi-device SpMM with the ring-overlapped halo exchange, through the
PyTorch port: four ranks on one card (each with its own planes and chunk
buffers; the chunk shifts run on side streams), or four CPU ranks.

Run: python examples/torch_03_multichip_halo.py [--device cpu] [--ranks 4]
Across processes, see README (torchrun ... -m tpusparse_torch.dist.dryrun --group).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from tpusparse_torch.dist import make_mesh
from tpusparse_torch.dist.overlap import build_halo_spmm, pack_halo_stripe
from tpusparse_torch.io import builder
from tpusparse_torch.oracle import check_result, spmm_reference

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda:0")
ap.add_argument("--ranks", type=int, default=4)
args = ap.parse_args()

d = args.ranks
mat = builder.power_law_coo(2048, 2048, avg_nnz_per_row=12.0, seed=0)
x = np.random.default_rng(1).standard_normal((2048, 16)).astype(np.float32)

mesh = make_mesh(d, 1, [args.device] * d)      # a LocalRing over the mesh
fmt = pack_halo_stripe(mat, d, rows_per_stripe=64, device=mesh.out_device)
fn, put_inputs = build_halo_spmm(fmt, mesh)
y = fn(*put_inputs(x))
check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=1e-3)
print(f"halo ring over {d} ranks of {mesh.out_device} OK; Y {tuple(y.shape)} "
      f"(pad {fmt.padding_rate:.2f})")
