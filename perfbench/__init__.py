"""perfbench: the benchmark of mfcc_tpu_torch on one CUDA card
(``README.md``; one run: ``python3 perfbench/run.py``)."""
