"""rtbench: the benchmark of rt_tpu_torch on one H100 (``rtbench/README.md``)."""
