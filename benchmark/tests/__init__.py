"""CPU tests of the benchmark's harness (``python -m pytest
benchmark/tests``); the tests that need a card skip without one."""
