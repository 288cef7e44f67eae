"""Command-line programs of the port, run with ``python -m``."""
