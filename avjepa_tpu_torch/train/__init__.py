"""Training pieces that serving shares (the feature LayerNorm)."""
