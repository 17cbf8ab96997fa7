"""The benchmark of the PyTorch and CUDA port
(``python_audio_mastering_tpu_torch``) on an NVIDIA H100.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Configurations,
traffic mixes, per-layer metrics, kernel roofline counts and each cell's
correctness limits are files found by name (``registry``).
"""
