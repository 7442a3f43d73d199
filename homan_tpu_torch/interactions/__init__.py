"""Physical interaction terms (this slice: pairwise distances only)."""
