"""Logical-axis sharding on a torch ``DeviceMesh`` (``partition``)."""
