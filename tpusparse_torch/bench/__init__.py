from tpusparse_torch.bench.harness import gflops, time_fn, time_fn_host

__all__ = ["time_fn", "time_fn_host", "gflops"]
