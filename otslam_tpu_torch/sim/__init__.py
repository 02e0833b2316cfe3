"""Analytic scenes and the RGB-D renderer."""
