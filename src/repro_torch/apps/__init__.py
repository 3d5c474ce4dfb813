"""Benchmark and example applications, written once in the ``core.lang`` AST
and used both by the static analysis and by the POS interpreter."""
