"""Models: the encoder and its parts, named with the reference state-dict keys."""
