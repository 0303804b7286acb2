"""Host-side readers of precomputed crops."""
