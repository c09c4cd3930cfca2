"""The benchmark of ``indoor_nerf_tpu_torch``, the PyTorch and CUDA port,
on an NVIDIA H100: ``python3 -m nerfbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
(``run.py``)."""
