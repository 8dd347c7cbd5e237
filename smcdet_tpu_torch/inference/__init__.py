"""Mutation kernel and the CS-SMC loop."""
