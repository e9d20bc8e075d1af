"""The benchmark of `repro_torch`: one cell (a configuration under a traffic
mix) per run of `perfbench/run.py`.  See `perfbench/README.md`."""
