"""Frozen plain references of the benchmark's training steps."""
