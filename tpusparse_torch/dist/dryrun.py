"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip`` and ``_train_step_dryrun``; its ``entry``, the
single-device flagship forward, is ``tpusparse_torch.entry``, imported
here as the JAX file holds both).

    python -m tpusparse_torch.dist.dryrun N [--device cpu]

runs, over N ranks on one device (the card by default; ``--cards`` puts
rank i on ``cuda:i``), the sharded stripe SpMM on an (N/2, 2) mesh, the
five halo rings on a 1-D mesh of N ranks against the oracle with the JAX
dry run's padding bounds, and a dp x tp training step whose loss must
fall over three SGD steps.  On a ``LocalRing`` the step's collectives are
sums and concatenations of the ranks' tensors.

    torchrun --nproc-per-node N -m tpusparse_torch.dist.dryrun --group [--device cpu]

runs the same rings with one rank a process (``GroupRing``: gloo for
``--device cpu``, NCCL on the cards, rank i on ``cuda:i``; X's chunks
move by ``batch_isend_irecv``, the row blocks are collected by
``all_gather``), each held to the oracle and to the same ring on a
``LocalRing`` in that process, then the data-parallel training checks,
whose collective is ``all_reduce``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpusparse_torch import entry  # noqa: F401 - the JAX file's sibling of dryrun_multichip
from tpusparse_torch.io import builder
from tpusparse_torch.oracle import check_result, spmm_reference


def _flagship(m=512, n=384, k=16, seed=0, device="cuda"):
    from tpusparse_torch.generator import prepare_stripe_format

    mat = builder.power_law_coo(m, n, avg_nnz_per_row=6.0, seed=seed)
    fmt, _ = prepare_stripe_format(mat, work_per_stripe=256, nnz_multiple=8, device=device)
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return mat, fmt, x


def halo_rings(n_devices: int, *, mesh=None, group=None, device="cuda"):
    """The five halo rings of the dry run on the 1024^2 power law (avg 16,
    seed 5) at the JAX dry run's geometry, the dgt ring packed both ways
    (resid with scatter 'select', and 'fullrow'): yields (name, matrix,
    format, fn, put_inputs, the oracle tolerance).  ``mesh`` (a one-column mesh
    or ``LocalRing``) or ``group`` (a process group) carries the ring."""
    from tpusparse_torch.dist import overlap as ov

    hm = 1024
    hmat = builder.power_law_coo(hm, hm, avg_nnz_per_row=16.0, seed=5)
    on = dict(group=group, device=device) if group is not None else {}
    pk = dict(device=device)
    rings = (
        ("stripe", lambda: ov.pack_halo_stripe(hmat, n_devices, rows_per_stripe=32, **pk),
         lambda f: ov.build_halo_spmm(f, mesh, unroll=4, **on), 1e-4),
        ("span", lambda: ov.pack_halo_span(hmat, n_devices, rows_per_program=64, ct=64, g=32,
                                           **pk),
         lambda f: ov.build_halo_span_spmm(f, mesh, **on), 1e-3),
        ("radix", lambda: ov.pack_halo_radix(hmat, n_devices, rows_per_program=64, S=16, g=32,
                                             kt=8, **pk),
         lambda f: ov.build_halo_radix_spmm(f, mesh, kt=8, **on), 2e-3),
        ("dg", lambda: ov.pack_halo_dg(hmat, n_devices, rows_per_program=128, ns=2, g=128,
                                       kt=8, **pk),
         lambda f: ov.build_halo_dg_spmm(f, mesh, kt=8, **on), 5e-4),
        ("dgt", lambda: ov.pack_halo_dgt(hmat, n_devices, rows_per_program=256, g=128, kt=8,
                                         resid=True, nw=8, walk="multi", **pk),
         lambda f: ov.build_halo_dgt_spmm(f, mesh, scatter="select", **on), 1e-3),
        ("dgt_fullrow", lambda: ov.pack_halo_dgt(hmat, n_devices, rows_per_program=256, g=128,
                                                 kt=8, resid=False, nw=8, walk="multi", **pk),
         lambda f: ov.build_halo_dgt_spmm(f, mesh, scatter="fullrow", **on), 1e-3),
    )
    for name, pack, build, tol in rings:
        fmt = pack()
        fn, put = build(fmt)
        yield name, hmat, fmt, fn, put, tol


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """The JAX dry run on ``n_devices`` ranks of ``device`` (or on the
    list ``devices``): returns each check's padding rate and the losses;
    any failure raises."""
    from tpusparse_torch.dist import build_sharded_stripe_spmm, make_mesh

    devs = list(devices) if devices is not None else [device] * n_devices
    n_k = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_row = n_devices // n_k
    mesh = make_mesh(n_row, n_k, devs)
    dev = mesh.out_device
    mat, fmt, _ = _flagship(m=256, n=192, k=16 * n_k, device=dev)
    x = np.random.default_rng(1).standard_normal((192, 16 * n_k)).astype(np.float32)
    fn, put_inputs = build_sharded_stripe_spmm(fmt, mesh, unroll=4)
    y = fn(*put_inputs(x))
    check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=1e-4)
    out = {"mesh": (n_row, n_k), "sharded_stripe": tuple(y.shape)}

    # the ring-overlapped halo paths on a 1024^2 matrix: the ring has
    # n_devices^2 x P buckets of >= G slots, so the 256-row flagship would
    # floor the padding at ~6x whatever the packer
    hmesh = make_mesh(n_devices, 1, devs)
    hx = np.random.default_rng(2).standard_normal((1024, x.shape[1])).astype(np.float32)
    hwant = None
    for name, hmat, hfmt, hfn, hput, tol in halo_rings(n_devices, mesh=hmesh, device=dev):
        if hwant is None:
            hwant = spmm_reference(hmat, hx.astype(np.float64))
        hy = hfn(*hput(hx))
        check_result(hy.cpu().numpy(), hwant, rtol=tol, what=f"{name} halo ring")
        out[name] = hfmt.padding_rate
    # the JAX dry run's padding bounds for the two dgt packs
    assert out["dgt"] <= 2.5, f"dgt halo pad {out['dgt']:.2f}"
    assert out["dgt_fullrow"] <= 1.5, f"dgt fullrow halo pad {out['dgt_fullrow']:.2f}"

    losses = _train_step_dryrun(mesh, mat)
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    out["losses"] = losses
    print(f"dryrun_multichip OK: mesh rows={n_row} k={n_k} on {sorted(set(map(str, devs)))}, "
          f"{fmt.n_stripes} stripes x {fmt.stripe_nnz} nnz, Y {tuple(y.shape)}; "
          + "; ".join(f"{k} halo pad {out[k]:.2f}"
                      for k in ("stripe", "span", "radix", "dg", "dgt", "dgt_fullrow"))
          + f"; train step dp{n_row}xtp{n_k} (loss {losses[0]:.3f}->{losses[-1]:.3f})")
    return out


def _train_layers(mat, dev, b_local):
    """The step's two sparse layers on ``dev``: the frozen pruned layer
    (``spmm_fn``: A's plan forward, A^T's backward) and the trainable-values
    layer on a 64 x out pruned weight (``spmm_trainable``: #7 forward, #14
    and #15 backward)."""
    from tpusparse_torch.autodiff import spmm_fn, spmm_trainable

    mat2 = builder.pruned_weight_coo(64, mat.shape[0], sparsity=0.8, seed=17)
    tfn, sv0 = spmm_trainable(mat2, rb=32, ct=64, g=32, device=dev)
    return spmm_fn(mat, k_hint=b_local, device=dev), tfn, sv0


def _train_step_dryrun(mesh, mat, steps: int = 3, group=None, device="cuda"):
    """The dp x tp training step on tiny shapes, ``steps`` SGD steps (lr
    1e-2); returns the losses.

    dp: batch rows split over the 'rows' ranks.  tp: W1 [F, H] column-split
    over the 'k' ranks, the hidden activation all-gathered inside the step.
    Downstream of W1 sit both sparse training stories: the frozen pruned
    layer and the trainable-values layer, so one backward crosses every
    sparse gradient kernel (#7, #14, #15 and the frozen plans').  Each rank
    keeps its own replica of the parameters and takes its own loss term;
    the all-gather's backward adds every 'k' rank's term into the shards,
    as in the JAX step; the gradients are all-reduced over 'rows'.  With
    ``group`` (a 1-D process group, this process's rank on ``device``) the
    collectives are ``all_reduce``; ``mesh`` is then unused."""
    F, H, out = 48, mat.shape[1], mat.shape[0]
    b_local = 8
    if group is not None:
        import torch.distributed as dist

        n_row, n_k = dist.get_world_size(group), 1
        ranks = [(dist.get_rank(group), 0)]
        devs = {ranks[0]: torch.device(device)}
    else:
        n_row, n_k = mesh.devices.shape
        ranks = [(r, j) for r in range(n_row) for j in range(n_k)]
        devs = {q: mesh.devices[q] for q in ranks}
    B, hb = b_local * n_row, H // n_k
    assert H % n_k == 0
    rng = np.random.default_rng(7)
    w1 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(np.float32)
    x = rng.standard_normal((B, F)).astype(np.float32)
    t = rng.standard_normal((B, 64)).astype(np.float32)

    layers, params, data = {}, {}, {}
    for q in ranks:
        dev = devs[q]
        if dev not in layers:
            layers[dev] = _train_layers(mat, dev, b_local)
        r, j = q
        params[q] = {"w1": torch.nn.Parameter(torch.tensor(w1[:, j * hb:(j + 1) * hb],
                                                           device=dev)),
                     "b1": torch.nn.Parameter(torch.zeros(hb, device=dev)),
                     "sv": torch.nn.Parameter(layers[dev][2].clone())}
        data[q] = (torch.from_numpy(x[r * b_local:(r + 1) * b_local]).to(dev),
                   torch.from_numpy(t[r * b_local:(r + 1) * b_local]).to(dev))
    opt = torch.optim.SGD([p for q in ranks for p in params[q].values()], lr=1e-2)
    out_dev = devs[ranks[0]]

    def local_loss(q, h_of):
        spmm, tfn, _ = layers[devs[q]]
        # the tp all-gather: every 'k' rank's shard of H, side by side
        h = torch.cat([h_of[(q[0], jj)].to(devs[q]) for jj in range(n_k)], dim=1)
        y = spmm(torch.relu(h).T.contiguous())                       # frozen [out, bl]
        y2 = tfn(params[q]["sv"], torch.relu(y)).T                   # trainable [bl, 64]
        return torch.sum((y2 - data[q][1]) ** 2) / (B * 64)          # this rank's term

    losses = []
    for _ in range(steps):
        opt.zero_grad()
        h_of = {q: data[q][0] @ params[q]["w1"] + params[q]["b1"] for q in ranks}
        terms = {q: local_loss(q, h_of) for q in ranks}
        sum(terms[q].to(out_dev) for q in ranks).backward()
        loss = sum(float(terms[q].detach()) for q in ranks if q[1] == 0)
        if group is not None:
            import torch.distributed as dist

            for p in params[ranks[0]].values():   # the dp all-reduce
                dist.all_reduce(p.grad, group=group)
            lt = torch.tensor([loss], dtype=torch.float64)
            dist.all_reduce(lt, group=group)
            loss = float(lt)
        else:
            for j in range(n_k):                  # the dp all-reduce over 'rows'
                for name in ("w1", "b1", "sv"):
                    g = sum(params[(r, j)][name].grad.to(out_dev) for r in range(n_row))
                    for r in range(n_row):
                        params[(r, j)][name].grad.copy_(g)
        opt.step()
        losses.append(loss)
    return losses


def group_checks(device="cpu", group=None, all_rings: bool = False) -> dict:
    """The checks of one rank a process, in every process of ``group``
    (the default group where None): the dg ring by ``GroupRing`` against
    the same ring on a ``LocalRing`` of the group's size in this process,
    within 1e-6 (with ``all_rings``, also the dry run's six rings, each
    against the oracle and its LocalRing twin); ``TrainableSparseLinear``
    gradients all-reduced over the ranks' batch shards against the one-rank
    gradients of the whole batch (rtol 2e-4, atol 1e-4, as
    tests/test_sddmm.py holds the JAX layer); the dp training step's losses
    falling.  Returns the measured gaps."""
    import torch.distributed as dist

    from tpusparse_torch.dist import make_mesh
    from tpusparse_torch.dist import overlap as ov
    from tpusparse_torch.nn import TrainableSparseLinear

    group = group if group is not None else dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = torch.device(device)
    mat = builder.power_law_coo(280, 300, avg_nnz_per_row=5.0, seed=7)
    x = np.random.default_rng(8).standard_normal((300, 16)).astype(np.float32)
    fmt = ov.pack_halo_dg(mat, world, rows_per_program=128, ns=2, g=128, kt=8, device=dev)
    gfn, gput = ov.build_halo_dg_spmm(fmt, group=group, device=dev, kt=8)
    lfn, lput = ov.build_halo_dg_spmm(fmt, make_mesh(world, 1, [dev] * world), kt=8)
    y_group, y_local = gfn(*gput(x)), lfn(*lput(x))
    ring_gap = float((y_group - y_local).abs().max())
    assert ring_gap <= 1e-6, f"rank {rank}: GroupRing and LocalRing differ by {ring_gap}"
    check_result(y_group.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=5e-4)
    if all_rings:
        hx = np.random.default_rng(2).standard_normal((1024, 16)).astype(np.float32)
        local = halo_rings(world, mesh=make_mesh(world, 1, [dev] * world), device=dev)
        for (name, hmat, _, gfn, gput, tol), (_, _, _, lfn, lput, _) in zip(
                halo_rings(world, group=group, device=dev), local):
            y_g = gfn(*gput(hx))
            gap = float((y_g - lfn(*lput(hx))).abs().max())
            assert gap <= 1e-6, f"rank {rank}: {name} ring: GroupRing and LocalRing differ by {gap}"
            check_result(y_g.cpu().numpy(), spmm_reference(hmat, hx.astype(np.float64)),
                         rtol=tol, what=f"{name} ring")
            ring_gap = max(ring_gap, gap)

    w = builder.pruned_weight_coo(32, 24, sparsity=0.7, seed=8)
    layer = TrainableSparseLinear(w, rb=16, ct=32, g=16, bias=False, device=dev)
    rng = np.random.default_rng(9)
    xb = torch.as_tensor(rng.standard_normal((8, 24)), dtype=torch.float32, device=dev)
    tb = torch.as_tensor(rng.standard_normal((8, 32)), dtype=torch.float32, device=dev)
    if 8 % world:
        raise ValueError(f"the batch of 8 does not split over {world} ranks")
    bl = 8 // world
    sl = slice(rank * bl, (rank + 1) * bl)
    torch.sum((layer(xb[sl]) - tb[sl]) ** 2).backward()
    g_dp = layer.vals.grad.clone()
    dist.all_reduce(g_dp, group=group)
    layer.vals.grad = None
    torch.sum((layer(xb) - tb) ** 2).backward()
    torch.testing.assert_close(g_dp, layer.vals.grad, rtol=2e-4, atol=1e-4)
    grad_gap = float((g_dp - layer.vals.grad).abs().max())

    tmat = builder.power_law_coo(128, 96, avg_nnz_per_row=6.0, seed=3)
    losses = _train_step_dryrun(None, tmat, group=group, device=dev)
    assert losses[-1] < losses[0], f"rank {rank}: loss did not decrease: {losses}"
    return {"rank": rank, "ring_gap": ring_gap, "grad_gap": grad_gap, "losses": losses}


def group_main(rank: int, world: int, init_method: str, device: str = "cpu",
               all_rings: bool = False) -> None:
    """One process of ``group_checks``: joins the group at ``init_method``
    (``file://...`` or ``tcp://localhost:<port>``) as ``rank`` of
    ``world`` (gloo on the CPU, NCCL on ``cuda:rank``), runs the checks and
    leaves."""
    import torch.distributed as dist

    backend = "gloo" if device == "cpu" else "nccl"
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    if dev != "cpu":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        out = group_checks(dev, all_rings=all_rings)
        print(f"group_checks rank {rank}/{world} ({backend}): {out}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", help="the device every rank sits on")
    ap.add_argument("--cards", action="store_true", help="rank i on cuda:i")
    ap.add_argument("--group", action="store_true",
                    help="one rank a process, under torchrun (RANK, WORLD_SIZE, MASTER_ADDR)")
    args = ap.parse_args(argv)
    if args.group:
        import os

        group_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                   "cpu" if args.device == "cpu" else "cuda", all_rings=True)
        return 0
    devices = ([f"cuda:{i}" for i in range(args.n_devices)] if args.cards else None)
    dryrun_multichip(args.n_devices, device=args.device, devices=devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
