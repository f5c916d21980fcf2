"""Batched serving engine."""
