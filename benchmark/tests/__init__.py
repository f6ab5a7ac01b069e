"""The benchmark's own CPU tests (python -m pytest benchmark/tests)."""
