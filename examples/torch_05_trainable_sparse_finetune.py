"""Fine-tune a pruned sparse weight matrix through the PyTorch port: fixed
pattern, trainable values.

The sparsity pattern is frozen (as pruning left it) and the surviving
values train.  The forward runs the span SpMM kernel; the value gradient
is an SDDMM sampled at the pattern and the input gradient a transpose
apply over the SAME packed format (tpusparse_torch/kernels/sddmm.py): no
repacking per optimizer step.

Run: python examples/torch_05_trainable_sparse_finetune.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from tpusparse_torch.io import builder
from tpusparse_torch.nn import TrainableSparseLinear

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# a 90%-pruned weight, the reference's FlashLLM workload class
w = builder.pruned_weight_coo(256, 192, sparsity=0.9, seed=0)
layer = TrainableSparseLinear(w, device=dev)

rng = np.random.default_rng(1)
x = torch.as_tensor(rng.standard_normal((64, 192)), dtype=torch.float32, device=layer.device)
target = torch.as_tensor(rng.standard_normal((64, 256)), dtype=torch.float32,
                         device=layer.device)
opt = torch.optim.Adam(layer.parameters(), lr=2e-2)

for i in range(40):
    opt.zero_grad()
    loss = torch.mean((layer(x) - target) ** 2)
    loss.backward()
    opt.step()
    if i % 10 == 0 or i == 39:
        print(f"step {i:3d}  loss {float(loss):.4f}")

# checkpoint: trained values back in the original COO nz order
trained = layer.export_vals().cpu().numpy()
print(f"exported {trained.shape[0]} trained values "
      f"(moved {np.abs(trained - np.asarray(w.vals)).mean():.3f} on average)")
