"""Real (non-generator) workload matrices from data already on disk
(counterpart of ``tpusparse/io/realdata.py``; the same extractors, giving
the port's ``CooMatrix``).

The reference's canonical inputs are SuiteSparse matrices and pruned-LLM
weights (matrix_example/README.md:1-30).  Nothing here downloads: the
matrices come from the Python sources installed beside the interpreter,
with the structural properties synthetic generators miss (locally dense
blocks, dense rows AND columns together, sub-1-average fringes):

- ``cooccurrence_coo``: symmetric token co-occurrence graph over the
  Python sources in site-packages and the standard library, a genuine text
  corpus: power-law degrees, hub rows and columns, block structure from
  per-package vocabularies (the web/social-graph class).
- ``docterm_coo``: the (file x token) count matrix over the same corpus,
  a real document-term matrix (the LSI/tf-idf class), rectangular with hub
  columns and sub-1-average fringe rows.
- ``import_graph_coo``: the directed module-import graph of the same
  files (the web-Google class).
- ``trained_pruned_weight``: the FFN up-projection of a small transformer
  LM actually trained (on ``device``) on that corpus, then
  magnitude-pruned: the FlashLLM workload recipe executed end to end.

The matrices depend on the files installed, so two machines give two
matrices; on one machine each is a pure function of its arguments.
"""

from __future__ import annotations

import io
import os
import tokenize
from typing import Iterable

import numpy as np

from tpusparse_torch.io.mtx import CooMatrix


def _python_sources(roots: Iterable[str] | None = None, max_files: int | None = None):
    """Yield paths of .py files under the interpreter's package roots."""
    if roots is None:
        import sysconfig

        roots = {sysconfig.get_paths()["purelib"], sysconfig.get_paths()["stdlib"]}
    n = 0
    for root in sorted(roots):
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "tests"))
            for f in sorted(filenames):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
                    n += 1
                    if max_files is not None and n >= max_files:
                        return


def cooccurrence_coo(
    vocab_size: int = 32768,
    window: int = 4,
    max_files: int = 4000,
    dtype=np.float32,
) -> CooMatrix:
    """Symmetric token co-occurrence matrix over real Python source text.

    Tokens are Python lexer tokens (names, ops, literals); the vocabulary
    keeps the ``vocab_size`` most frequent, and edge (i, j) counts
    co-occurrences within ``window`` tokens.  log1p-weighted values."""
    from collections import Counter

    streams = []
    for path in _python_sources(max_files=max_files):
        try:
            with open(path, "rb") as f:
                src = f.read()
            toks = [t.string for t in tokenize.tokenize(io.BytesIO(src).readline)
                    if t.string and not t.string.isspace()]
            streams.append(toks)
        except Exception:
            continue
    counts = Counter()
    for toks in streams:
        counts.update(toks)
    vocab = {w: i for i, (w, _) in enumerate(counts.most_common(vocab_size))}
    uks, ucs = [], []
    for toks in streams:
        ids = [vocab[t] for t in toks if t in vocab]
        arr = np.asarray(ids, dtype=np.int64)
        ks = []
        for off in range(1, window + 1):
            a, b = arr[:-off], arr[off:]
            ks.append(np.minimum(a, b) * vocab_size + np.maximum(a, b))
        if ks:
            uk, uc = np.unique(np.concatenate(ks), return_counts=True)
            uks.append(uk)
            ucs.append(uc)
    allk = np.concatenate(uks)
    allc = np.concatenate(ucs)
    order_k = np.argsort(allk, kind="stable")
    allk, allc = allk[order_k], allc[order_k]
    new = np.empty(allk.size, dtype=bool)
    new[0] = True
    np.not_equal(allk[1:], allk[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    keys = allk[starts]
    cnts = np.add.reduceat(allc, starts)
    r = keys // vocab_size
    c = keys % vocab_size
    # symmetrize (keep the diagonal once)
    off_diag = r != c
    rows = np.concatenate([r, c[off_diag]])
    cols = np.concatenate([c, r[off_diag]])
    vals = np.log1p(np.concatenate([cnts, cnts[off_diag]])).astype(dtype)
    n = vocab_size
    order = np.lexsort((cols, rows))
    return CooMatrix(rows=rows[order], cols=cols[order], vals=vals[order],
                     shape=(n, n))


def docterm_coo(
    vocab_size: int = 32768,
    max_files: int = 8000,
    dtype=np.float32,
) -> CooMatrix:
    """(file x token) count matrix over real Python source text — a genuine
    document-term matrix.  log1p-weighted values."""
    from collections import Counter

    streams = []
    for path in _python_sources(max_files=max_files):
        try:
            with open(path, "rb") as f:
                src = f.read()
            toks = [t.string for t in tokenize.tokenize(io.BytesIO(src).readline)
                    if t.string and not t.string.isspace()]
            if toks:
                streams.append(toks)
        except Exception:
            continue
    counts = Counter()
    for toks in streams:
        counts.update(toks)
    vocab = {w: i for i, (w, _) in enumerate(counts.most_common(vocab_size))}
    rows_l, cols_l, vals_l = [], [], []
    for fi, toks in enumerate(streams):
        ids = np.asarray([vocab[t] for t in toks if t in vocab], dtype=np.int64)
        if ids.size == 0:
            continue
        uk, uc = np.unique(ids, return_counts=True)
        rows_l.append(np.full(uk.size, fi, dtype=np.int64))
        cols_l.append(uk)
        vals_l.append(np.log1p(uc).astype(dtype))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    order = np.lexsort((cols, rows))
    return CooMatrix(rows=rows[order], cols=cols[order], vals=vals[order],
                     shape=(len(streams), vocab_size))


def import_graph_coo(max_files: int = 30000, dtype=np.float32) -> CooMatrix:
    """Directed module-import graph over the Python sources installed
    beside the interpreter: node =
    module file, edge src -> dst when src imports dst (``import a.b`` /
    ``from a.b import c``; relative imports resolved against the source
    package).  The web-Google class structure the text matrices lack:
    power-law IN-degree (hub modules: typing, os, numpy) with near-uniform
    short out-degree rows, asymmetric and non-block-diagonal."""
    import ast
    import sysconfig

    roots = sorted({sysconfig.get_paths()["purelib"],
                    sysconfig.get_paths()["stdlib"]})

    def mod_name(path):
        for root in roots:
            if path.startswith(root + os.sep):
                rel = path[len(root) + 1:-3]  # strip root + ".py"
                name = rel.replace(os.sep, ".")
                if name.endswith(".__init__"):
                    name = name[: -len(".__init__")]
                return name
        return None

    paths = list(_python_sources(max_files=max_files))
    names = [mod_name(p) for p in paths]
    known = {n: i for i, n in enumerate(names) if n}

    def resolve(target):
        # longest known prefix: "a.b.c" may be a symbol of module "a.b"
        while target:
            if target in known:
                return known[target]
            if "." not in target:
                return None
            target = target.rsplit(".", 1)[0]
        return None

    rows_l, cols_l = [], []
    for path, name in zip(paths, names):
        if not name or name not in known:
            continue
        src_id = known[name]
        pkg = name.rsplit(".", 1)[0] if "." in name else ""
        try:
            tree = ast.parse(open(path, "rb").read())
        except Exception:
            continue
        targets = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                targets += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: climb from the source package
                    base = name.split(".")
                    base = base[: max(len(base) - node.level, 0)]
                    mod = ".".join(base + ([node.module] if node.module else []))
                else:
                    mod = node.module or ""
                targets.append(mod)
                targets += [f"{mod}.{a.name}" for a in node.names]
        del pkg
        ids = {resolve(t) for t in targets if t}
        ids.discard(None)
        ids.discard(src_id)
        for dst in ids:
            rows_l.append(src_id)
            cols_l.append(dst)
    rows = np.asarray(rows_l, dtype=np.int64)
    cols = np.asarray(cols_l, dtype=np.int64)
    n = len(names)
    vals = np.ones(rows.size, dtype=dtype)
    order = np.lexsort((cols, rows))
    return CooMatrix(rows=rows[order], cols=cols[order], vals=vals[order],
                     shape=(n, n))


def _corpus_text(max_bytes: int = 8 << 20) -> bytes:
    """A real text corpus: concatenated Python sources from disk."""
    buf = []
    total = 0
    for path in _python_sources():
        try:
            b = open(path, "rb").read()
        except Exception:
            continue
        buf.append(b)
        total += len(b)
        if total >= max_bytes:
            break
    return b"\n".join(buf)[:max_bytes]


def trained_pruned_weight(
    d_model: int = 768,
    d_ff: int = 3072,
    steps: int = 300,
    sparsity: float = 0.9,
    seq: int = 256,
    batch: int = 8,
    seed: int = 0,
    device="cuda",
):
    """Train a small byte-level transformer LM on the on-disk corpus on
    ``device``, then magnitude-prune its FFN up-projection to ``sparsity``:
    genuine trained weights through the FlashLLM recipe (magnitude
    pruning), not a random mask.  The weights are initialised on the CPU
    from ``seed`` (the global generator is left as it was) and the batches
    drawn by ``numpy.random.default_rng(seed)``, so the CPU run gives the
    JAX package's weights.  Returns (CooMatrix, metadata dict)."""
    import torch
    import torch.nn as nn

    from tpusparse_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    data = np.frombuffer(_corpus_text(), dtype=np.uint8).astype(np.int64)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = nn.MultiheadAttention(d_model, 8, batch_first=True)
            self.ln1 = nn.LayerNorm(d_model)
            self.ln2 = nn.LayerNorm(d_model)
            self.up = nn.Linear(d_model, d_ff)
            self.down = nn.Linear(d_ff, d_model)

        def forward(self, h, mask):
            a, _ = self.attn(self.ln1(h), self.ln1(h), self.ln1(h),
                             attn_mask=mask, need_weights=False)
            h = h + a
            return h + self.down(torch.relu(self.up(self.ln2(h))))

    class LM(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(256, d_model)
            self.pos = nn.Parameter(torch.zeros(seq, d_model))
            self.blocks = nn.ModuleList([Block() for _ in range(2)])
            self.head = nn.Linear(d_model, 256)

        def forward(self, x):
            h = self.emb(x) + self.pos[: x.shape[1]]
            mask = torch.triu(torch.full((x.shape[1], x.shape[1]), float("-inf"),
                                         device=x.device), 1)
            for b in self.blocks:
                h = b(h, mask)
            return self.head(h)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LM()
    model = model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, len(data) - seq - 1, size=batch)
        xb = torch.from_numpy(np.stack([data[i:i + seq] for i in idx])).to(dev)
        yb = torch.from_numpy(np.stack([data[i + 1:i + seq + 1] for i in idx])).to(dev)
        logits = model(xb)
        loss = nn.functional.cross_entropy(logits.reshape(-1, 256), yb.reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    w = model.blocks[0].up.weight.detach()  # (d_ff, d_model), trained
    thresh = torch.quantile(w.abs().flatten().float(), sparsity)
    pruned = torch.where(w.abs() >= thresh, w, torch.zeros_like(w))
    meta = {
        "steps": steps,
        "loss_first": losses[0],
        "loss_last": float(np.mean(losses[-20:])),
        "sparsity": float((pruned == 0).float().mean()),
        "shape": tuple(pruned.shape),
    }
    return CooMatrix.from_torch(pruned.to_sparse_coo()), meta
