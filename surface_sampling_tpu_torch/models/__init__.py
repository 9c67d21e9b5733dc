"""PaiNN ensemble forward on rigid lattices and its weights."""
