"""Utilities of the port: env-gated debug dumps (``debug``)."""
