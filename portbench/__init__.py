"""The benchmark of the PyTorch + CUDA port (``segmif_tpu_torch``) on
NVIDIA H100 cards: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``BENCHMARK.json`` at the repository's
root for the cells and metrics, and ``PERF.md`` for why each exists."""
