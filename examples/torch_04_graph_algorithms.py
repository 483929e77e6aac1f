"""BFS / PageRank / connected components over semiring SpMV, through the
PyTorch port.

Run: python examples/torch_04_graph_algorithms.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from tpusparse_torch import graph
from tpusparse_torch.io import builder

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

g = builder.power_law_coo(5000, 5000, avg_nnz_per_row=6.0, seed=0)
level = graph.bfs(g, source=0, device=dev)
pr = graph.pagerank(g, device=dev)
cc = graph.connected_components(g, device=dev)
print(f"bfs reached {(level >= 0).sum()} vertices (max depth {level.max()})")
print(f"pagerank mass {pr.sum():.4f}, top vertex {int(np.argmax(pr))}")
print(f"{len(np.unique(cc))} connected components")
