"""The benchmark of koopmanx_torch: one command runs one cell once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own (``configs/``, ``traffic/``, ``metrics/``,
``limits/``), found by the name ``BENCHMARK.json`` gives it; see
``benchmark/README.md``.
"""
