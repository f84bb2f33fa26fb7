"""The port's command-line scripts, run with ``python -m``."""
