"""The command line: flag parsing (``cli.config``) and the entry point
(``cli.main``), the port of ``fontrx/cli``. ``python -m fontrx_torch`` runs
``cli.main.main``."""
