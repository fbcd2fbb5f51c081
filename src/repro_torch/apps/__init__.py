"""The paper's own programs on PyTorch (§7): the benchmark workloads
(Tables 3-4, the §7.3 applications), the measurement harness and the
experiment drivers behind ``python -m repro_torch.apps.run``."""
