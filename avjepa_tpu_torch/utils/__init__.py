"""Weight bridges and checkpoint reading."""
