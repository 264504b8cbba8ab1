"""One module per configuration of ``BENCHMARK.json``, found by its name."""
