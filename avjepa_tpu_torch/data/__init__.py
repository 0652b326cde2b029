"""Host-side data pipeline: datasets, transforms and the batch loader."""
