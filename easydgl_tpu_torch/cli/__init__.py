"""Command-line entry points of the port: ``cli.train`` and
``cli.analytics``."""
