"""The port's benchmarks: ``python -m repro_torch.benchmarks.<name>`` for
``bench_control_flow``, ``bench_sm``, ``bench_timing``, ``bench_kernels``,
``run``, ``bench_analysis``, ``bench_archive`` and ``bench_service`` (each
with ``--device``: the card by default, ``cpu`` for the plain twins)."""
