"""Two-layer GCN node classification through the PyTorch port's packed
SpMM kernels.

Every GCN layer is H' = act(Â · (H W)) with Â the symmetric-normalized
adjacency (Kipf & Welling).  ``autodiff.spmm_fn`` wires the packed forward
kernel AND a packed transpose kernel for the cotangent (dX = Âᵀ·dY), so
both passes of training run the hand-written kernels; the optimizer is
``torch.optim.Adam``.

The graph is a planted partition (stochastic block model): C communities
with dense intra-community and sparse inter-community edges; the labels
are the planted communities and the features noisy one-hot community
indicators, so a working GCN separates them in a few steps.

Run: python examples/torch_06_gcn_node_classification.py [--nodes 4096]
     [--communities 8] [--steps 30] [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from tpusparse_torch.io.mtx import CooMatrix


def planted_partition(n, c, deg_in=12, deg_out=3, seed=0):
    """Symmetric SBM adjacency in COO + community labels."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, c, n)
    order = np.argsort(label, kind="stable")  # contiguous communities
    label = label[order]
    starts = np.searchsorted(label, np.arange(c))
    ends = np.searchsorted(label, np.arange(c), side="right")
    rows, cols = [], []
    for ci in range(c):
        members = np.arange(starts[ci], ends[ci])
        if members.size < 2:
            continue
        e_in = deg_in * members.size // 2
        rows.append(rng.choice(members, e_in))
        cols.append(rng.choice(members, e_in))
        # out-edges are uniform over ALL nodes, so ~1/C of them land back
        # inside the source community
        e_out = deg_out * members.size // 2
        rows.append(rng.choice(members, e_out))
        cols.append(rng.integers(0, n, e_out))
    r = np.concatenate(rows)
    cc = np.concatenate(cols)
    keep = r != cc
    r, cc = r[keep], cc[keep]
    r2 = np.concatenate([r, cc])   # symmetrize
    c2 = np.concatenate([cc, r])
    m = CooMatrix(r2, c2, np.ones(r2.size, np.float32), (n, n))
    return m.sort_row_major().dedup(), label


def normalize_adj(mat):
    """Â = D^-1/2 (A + I) D^-1/2 on the host COO."""
    n = mat.shape[0]
    rows = np.concatenate([mat.rows, np.arange(n)])
    cols = np.concatenate([mat.cols, np.arange(n)])
    vals = np.concatenate([np.asarray(mat.vals, np.float64), np.ones(n)])
    deg = np.bincount(rows, weights=vals, minlength=n)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vals = (vals * dinv[rows] * dinv[cols]).astype(np.float32)
    return CooMatrix(rows, cols, vals, (n, n)).sort_row_major().dedup()


def main():
    from tpusparse_torch.autodiff import spmm_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--communities", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    n, c = args.nodes, args.communities
    mat, label = planted_partition(n, c, seed=3)
    adj = normalize_adj(mat)
    h = args.hidden
    aspmm = spmm_fn(adj, k_hint=h, device=args.device)  # packed forward + transpose backward
    dev = aspmm.plan.formats[0].device if aspmm.plan.formats else torch.device(args.device)
    print(f"graph: {n} nodes, {adj.nnz} normalized edges, {c} communities, device={dev}")

    rng = np.random.default_rng(1)
    feats = np.eye(c, dtype=np.float32)[label] + \
        0.5 * rng.standard_normal((n, c)).astype(np.float32)
    x = torch.as_tensor(feats, device=dev)
    y = torch.as_tensor(label, device=dev)
    train_mask = torch.as_tensor(rng.random(n) < 0.3, device=dev)
    w0 = torch.nn.Parameter(torch.as_tensor(rng.standard_normal((c, h)) / np.sqrt(c),
                                            dtype=torch.float32, device=dev))
    w1 = torch.nn.Parameter(torch.as_tensor(rng.standard_normal((h, c)) / np.sqrt(h),
                                            dtype=torch.float32, device=dev))

    def model(xin):
        h1 = torch.relu(aspmm(xin @ w0))
        return aspmm(h1 @ w1)

    opt = torch.optim.Adam([w0, w1], lr=1e-2)
    t0 = time.time()
    for i in range(args.steps):
        opt.zero_grad()
        logits = model(x)
        ll = torch.nn.functional.cross_entropy(logits, y, reduction="none")
        loss = torch.where(train_mask, ll, 0.0).sum() / train_mask.sum()
        loss.backward()
        opt.step()
        if i % 5 == 0 or i == args.steps - 1:
            acc = float((logits.argmax(-1) == y).float().mean())
            print(f"step {i:3d}: loss {float(loss):.4f}  acc {acc:.3f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")
    with torch.no_grad():
        logits = model(x)
    test_acc = float((logits.argmax(-1) == y)[~train_mask].float().mean())
    print(f"held-out accuracy: {test_acc:.3f} (chance {1.0 / c:.3f})")
    assert test_acc > 2.0 / c, "GCN failed to beat 2x chance"
    print("OK")


if __name__ == "__main__":
    main()
