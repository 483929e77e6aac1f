"""tpusparse_torch.dist across processes: four gloo ranks on the CPU, one
rank a process (``GroupRing``), spawned with a FileStore under the test's
own directory so that parallel workers never share a port.  Each rank
runs ``dryrun.group_checks``: the dg ring by GroupRing equals the same
ring on a LocalRing within 1e-6; TrainableSparseLinear gradients
all-reduced over four batch shards equal the one-rank gradients of the
whole batch at rtol 2e-4, atol 1e-4 (tests/test_sddmm.py::
test_trainable_dp_sharded_grads); the data-parallel training step's loss
falls.  The spawned children import only torch and tpusparse_torch."""

import torch.multiprocessing as mp

from tpusparse_torch.dist.dryrun import group_main


def test_four_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")   # the loopback device only
    monkeypatch.setenv("HOME", str(tmp_path))
    init = f"file://{tmp_path / 'store'}"
    mp.spawn(group_main, args=(4, init, "cpu"), nprocs=4, join=True)
