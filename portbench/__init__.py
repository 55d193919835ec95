"""The benchmark of the PyTorch and CUDA port (`gta_tpu_torch`): a harness
driven by the files beside it (run.py says how), its traffic generator,
its plain reference and the arithmetic of its metrics."""
