"""The benchmark of the PyTorch and CUDA port (``criteria3d_tpu_torch``):
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``benchmark/README.md``."""
