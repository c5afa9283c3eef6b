"""CPU tests of the benchmark (python -m pytest gibbsbench/tests)."""
