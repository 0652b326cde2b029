"""Serving entry points: frozen-encoder feature extraction."""
