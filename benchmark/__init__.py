"""The benchmark of the PyTorch and CUDA port (``omg_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card it is started on and
prints one JSON line. Cells, configurations, traffic mixes, entries and
per-layer metrics are files under this folder, found by name.
"""
