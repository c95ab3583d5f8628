"""The codec's benchmark: one cell a process, host bytes to host bytes on
the card.  ``run.py`` is the command; ``BENCHMARK.json`` at the root of
the checkout names the cells, metrics and bounds."""
