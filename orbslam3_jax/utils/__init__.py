"""Host-side utilities: datasets, evaluation, trajectory IO, config, timing."""
