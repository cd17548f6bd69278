"""Atomic, manifest-driven checkpoints of parameter and optimizer trees."""
