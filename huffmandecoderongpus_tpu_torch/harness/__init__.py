"""Command line of the port."""
