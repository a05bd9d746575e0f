"""The benchmark of btsbot_tpu_torch: ``python3 benchmark/run.py --workload <cell> ...``
(see ``run.py``); ``BENCHMARK.json`` at the repository root names its cells."""
