"""Utilities: profiling, persistence, validation."""
