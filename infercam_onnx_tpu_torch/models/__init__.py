"""UltraFace network, weight conversion and checkpoint reading."""
