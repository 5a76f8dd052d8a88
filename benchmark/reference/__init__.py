"""The plain PyTorch reference the correctness check holds the system to.
It imports nothing of the system under test."""
