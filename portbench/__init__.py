"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell a
run, driven by ``BENCHMARK.json`` and the files named after its entries
(``configs/``, ``mixes/``, ``metrics/``, ``checks/``).  Run
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root."""
