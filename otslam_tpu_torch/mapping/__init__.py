"""2D map workflows: scan-to-map localization."""
