from tpusparse_torch.bench.harness import device_time_fn, gflops, time_fn, time_fn_host

__all__ = ["time_fn", "time_fn_host", "device_time_fn", "gflops"]
