"""Dataset reader and the per-object reconstruction pipeline."""
