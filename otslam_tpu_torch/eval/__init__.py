"""Map-quality metrics and GT scenarios."""
