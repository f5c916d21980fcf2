"""Assigned architecture configs (public-literature exact settings)."""

from .base import (ArchConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
                   shape_applicable, smoke_variant)
from .registry import ARCHS, get_arch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "shape_applicable", "smoke_variant", "ARCHS", "get_arch"]
