"""Mask IR, online softmax and attention dispatch."""
