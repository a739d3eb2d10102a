"""CPU tests of the benchmark harness; the card tests are marked ``cuda``."""
