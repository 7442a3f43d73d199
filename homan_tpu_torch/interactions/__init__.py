"""Physical interaction terms: interior SDFs and their voxelizer kernel,
contact and pairwise distances."""
