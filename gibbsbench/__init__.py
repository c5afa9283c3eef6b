"""The benchmark of ``numbskull_tpu_torch`` on one H100 (see run.py)."""
