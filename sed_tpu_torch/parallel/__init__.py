"""Parallel and time-sharded inference helpers."""
