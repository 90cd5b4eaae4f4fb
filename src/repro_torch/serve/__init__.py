"""Retrieval and LM serving."""
