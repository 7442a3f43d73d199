"""Evidence front end (this slice: the synthetic ground-truth scene)."""
