"""SparseLinear in a tiny model through the PyTorch port: pruned weights,
batched dims, autograd.

Run: python examples/torch_02_sparse_linear_layer.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from tpusparse_torch.io import builder
from tpusparse_torch.nn import SparseLinear

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# 90%-magnitude-pruned weights, as from an LLM checkpoint.
# differentiable=True wires a packed A^T plan as the backward, so
# gradients flow through the sparse kernels.
w1 = builder.pruned_weight_coo(1024, 768, sparsity=0.9, seed=0)
w2 = builder.pruned_weight_coo(256, 1024, sparsity=0.9, seed=1)
layer1 = SparseLinear.from_coo(w1, differentiable=True, device=dev)
layer2 = SparseLinear.from_coo(w2, differentiable=True, device=dev)


def model(x):
    return layer2(torch.relu(layer1(x)))


x = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 16, 768)),
                    dtype=torch.float32, device=layer1.device).requires_grad_()
y = model(x)                                 # [batch, seq, features]
(g,) = torch.autograd.grad(torch.sum(model(x) ** 2), x)
print("forward:", tuple(y.shape), "grad:", tuple(g.shape))

# inference-only N:M (2:4) structured layer on the compact path
w_nm = builder.nm_pruned_dense(256, 1024, n_keep=2, group=4, seed=3)
head = SparseLinear.from_nm(w_nm, precision="bf16", device=dev)
with torch.no_grad():
    logits = head(torch.relu(layer1(x)))
print("N:M head:", tuple(logits.shape))
