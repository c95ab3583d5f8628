"""Utilities of the port: env-gated debug dumps (``debug``), and the
spans and counters of the codec's host work (``trace``)."""
