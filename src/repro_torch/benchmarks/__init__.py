"""The port's benchmarks: ``python -m repro_torch.benchmarks.bench_analysis``
and ``python -m repro_torch.benchmarks.bench_archive`` (each with
``--smoke`` and ``--device``; the card by default)."""
