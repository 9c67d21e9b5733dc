"""Batches of chains."""
